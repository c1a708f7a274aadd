"""Plain PyTorch version of the RG-LRU scan kernel (counterpart of
``repro.kernels.rglru_scan.ref``).

The JAX oracle runs an associative scan; PyTorch has none, so this walks T
with the state in f32.  A log-space cumulative product would underflow:
products of a_t in (0, 1) reach 0 long before T = 512."""
from __future__ import annotations

import torch


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """h_t = a_t·h_{t-1} + b_t per channel.  a, b: (B, T, D); h0: (B, D)
    → (h (B, T, D), h_last (B, D)), both in a's dtype."""
    af, bf = a.float(), b.float()
    h = h0.float()
    out = torch.empty_like(af)
    for t in range(a.shape[1]):
        h = torch.addcmul(bf[:, t], af[:, t], h)
        out[:, t] = h
    return out.to(a.dtype), h.to(a.dtype)


def rglru_scan_chunked_ref(a: torch.Tensor, b: torch.Tensor,
                           h0: torch.Tensor, *, chunk: int,
                           carry: bool = True):
    """The chunked kernel's algorithm in plain torch, contract as
    ``rglru_scan_ref``.  T is cut into nc = ceil(T / chunk) chunks (the
    last one ragged).  Each chunk walks its steps from zero, giving its
    local state h_c and its product A_c = ∏ a_t; the carry, in chunk
    order, gives each chunk's incoming state: h_in(0) = h0,
    h_in(c+1) = A_c·h_in(c) + h_c; each chunk walks its steps again from
    h_in(c) and writes h_t.  h_last is the last step's h_t (h0 for T 0).
    All in f32, each output rounded once to a's dtype.

    ``carry=False`` drops the carry (every chunk walks from zero): the one
    fault the chunking can bring, which the tests must see."""
    bsz, t, d = a.shape
    nc = max(1, -(-t // chunk))
    pad = nc * chunk - t

    def chunks(x, fill):            # (B, T, D) → (chunk, B, nc, D)
        x = torch.nn.functional.pad(x.float(), (0, 0, 0, pad), value=fill)
        return x.reshape(bsz, nc, chunk, d).permute(2, 0, 1, 3)

    # padded steps: a = 1, b = 0, so they leave h as it is
    ac, bc = chunks(a, 1.0), chunks(b, 0.0)
    h_loc = torch.zeros(bsz, nc, d)
    prod = torch.ones(bsz, nc, d)
    for i in range(chunk):
        h_loc = torch.addcmul(bc[i], ac[i], h_loc)
        prod = prod * ac[i]
    h_in = torch.zeros(bsz, nc, d)
    h_in[:, 0] = h0.float()
    if carry:
        for c in range(nc - 1):
            h_in[:, c + 1] = prod[:, c] * h_in[:, c] + h_loc[:, c]
    h = h_in
    out = torch.empty(chunk, bsz, nc, d)
    for i in range(chunk):
        h = torch.addcmul(bc[i], ac[i], h)
        out[i] = h
    out = out.permute(1, 2, 0, 3).reshape(bsz, nc * chunk, d)[:, :t]
    last = out[:, -1] if t else h0.float()
    return out.to(a.dtype), last.to(a.dtype)
