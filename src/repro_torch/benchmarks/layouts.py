"""Layout-election benchmark (counterpart of ``benchmarks/layouts.py``):
measure the choices ``passes.assign_layouts`` asserts, with torch ops on
the card unless ``device="cpu"``.

  * Linear weight layout: 'oi' (out, in; ``F.linear``, torch's own) against
    'io' (in, out; ``torch.matmul`` on the (in, out) weight).
  * Conv data layout: NCHW against NHWC (``channels_last`` tensors).

The derived column gives the measured winner and what each registered
backend's ``preferred_layout`` elects, so drift between the model and the
data shows in every run.  ``--apply`` writes the measured winners into
every registered backend for the session (``set_layout_preference``).

    PYTHONPATH=src python -m repro_torch.benchmarks.layouts [--apply] \\
        [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..frontends.offload import DeviceLike, resolve_device

Row = Tuple[str, float, str]


def _backend_prefs(kind: str) -> str:
    from ..backends import available_backends
    from ..core import ir
    from ..core.ir import Node, OpKind, TensorSpec
    if kind == "linear":
        node = Node(OpKind.LINEAR, [ir.input_node((1, 8))],
                    TensorSpec((1, 8)), attrs={"out_features": 8})
    else:
        node = Node(OpKind.CONV2D, [ir.input_node((1, 8, 8, 8))],
                    TensorSpec((1, 8, 8, 8)), attrs={"out_channels": 8})
    return "|".join(f"{n}={b.preferred_layout(node)}"
                    for n, b in sorted(available_backends().items()))


def bench(device: DeviceLike = None
          ) -> Tuple[List[Row], Dict[str, str]]:
    """Rows plus the overall winners by total time across the shapes:
    {'linear': 'oi'|'io', 'conv': 'nchw'|'nhwc'}.  Times are
    ``core.measure``'s min of 10 calls (CUDA events on the card), with
    PyTorch's products and convs in full f32."""
    from ..core.measure import full_f32, time_call_stats

    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(0)
    rows: List[Row] = []
    totals = {"oi": 0.0, "io": 0.0, "nchw": 0.0, "nhwc": 0.0}

    def timed(fn) -> float:
        return time_call_stats(fn, 3, 10, dev).min_us

    with full_f32():
        for b, d_in, d_out in ((32, 1024, 1024), (8, 4096, 512)):
            x = torch.randn((b, d_in), generator=gen, device=dev)
            w_oi = torch.randn((d_out, d_in), generator=gen, device=dev)
            w_io = w_oi.T.contiguous()
            t_oi = timed(lambda: F.linear(x, w_oi))
            t_io = timed(lambda: torch.matmul(x, w_io))
            totals["oi"] += t_oi
            totals["io"] += t_io
            win = "oi" if t_oi <= t_io else "io"
            tag = f"linear_{b}x{d_in}x{d_out}"
            rows.append((f"layout_{tag}_oi", t_oi, dev.type))
            rows.append((f"layout_{tag}_io", t_io,
                         f"faster={win};{_backend_prefs('linear')}"))

        for b, c_in, c_out, hw in ((4, 32, 64, 32), (1, 64, 128, 16)):
            x = torch.randn((b, c_in, hw, hw), generator=gen, device=dev)
            w = torch.randn((c_out, c_in, 3, 3), generator=gen, device=dev)
            x_nhwc = x.to(memory_format=torch.channels_last)
            w_nhwc = w.to(memory_format=torch.channels_last)
            t_nchw = timed(lambda: F.conv2d(x, w, padding=1))
            t_nhwc = timed(lambda: F.conv2d(x_nhwc, w_nhwc, padding=1))
            totals["nchw"] += t_nchw
            totals["nhwc"] += t_nhwc
            win = "nchw" if t_nchw <= t_nhwc else "nhwc"
            tag = f"conv_{b}x{c_in}to{c_out}x{hw}"
            rows.append((f"layout_{tag}_nchw", t_nchw, dev.type))
            rows.append((f"layout_{tag}_nhwc", t_nhwc,
                         f"faster={win};{_backend_prefs('conv')}"))
    winners = {
        "linear": "oi" if totals["oi"] <= totals["io"] else "io",
        "conv": "nchw" if totals["nchw"] <= totals["nhwc"] else "nhwc",
    }
    return rows, winners


def csv_rows(device: DeviceLike = None) -> List[Row]:
    return bench(device)[0]


def apply_measured(winners: Dict[str, str]) -> Dict[str, str]:
    """Write the measured winners into every registered backend for the
    session.  Returns {backend: 'old→new'} for the preferences that
    changed."""
    from ..backends import (available_backends, get_backend,
                            set_layout_preference)
    changes: Dict[str, str] = {}
    for name in sorted(available_backends()):
        before = get_backend(name)
        set_layout_preference(name, linear=winners["linear"],
                              conv=winners["conv"])
        after = get_backend(name)
        diff = []
        if before.linear_weight_layout != after.linear_weight_layout:
            diff.append(f"linear:{before.linear_weight_layout}"
                        f"→{after.linear_weight_layout}")
        if before.conv_layout != after.conv_layout:
            diff.append(f"conv:{before.conv_layout}→{after.conv_layout}")
        if diff:
            changes[name] = ",".join(diff)
    return changes


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--apply", action="store_true",
                    help="write the measured winners into the backend "
                         "registry for this session")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    rows, winners = bench(args.device)
    print("name,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.3f},{derived}")
    print(f"[layouts] measured winners: {winners}", file=sys.stderr)
    if args.apply:
        changes = apply_measured(winners)
        print(f"[layouts] applied to registry; changed: "
              f"{changes or 'nothing (static strings already agree)'}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
