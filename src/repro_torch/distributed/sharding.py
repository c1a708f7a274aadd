"""Partition rules over a SOL IR graph (counterpart of the serving side of
``repro.distributed.sharding``).

:func:`shard_graph` threads the rule table through the middleware: one topo
walk gives every node a :class:`P` (PartitionSpec) of its GLOBAL shape — DP
on the batch dim of inputs, Megatron-style TP for attention (q/k/v
column-parallel so heads stay shard-local, o row-parallel) and for MLP
pairs (column → elementwise → row), KV caches sharded on the kv-head axis —
then rewrites every ``node.spec`` (and RESHAPE ``shape``, LINEAR
``out_features``) to the per-shard LOCAL shape, and marks row-parallel
LINEAR/MATMUL nodes with ``attrs['psum_axes']``: the all-reduce the
executor lowers right after the partial product, before any downstream
bias add; :func:`column_parallel` reads the column-parallel products back
from the specs, whose inputs' gradients the differentiable lowering
all-reduces.  Because the rewrite happens before ``passes.run_pipeline``,
elections, autotune lookups, Tunable pinning and strict provenance all see
per-shard shapes; :func:`mesh_backend` qualifies the autotune-cache key so
mesh timings and single-device timings never alias.

The backbone's rules (:func:`param_spec`, :func:`param_specs`,
:func:`batch_specs`, :func:`cache_specs`) are the JAX module's, by name
and rank with the same divisibility fallbacks: pure functions over
(path, shape) that assign a :class:`P` to every leaf of a parameter,
batch or cache tree (tensors, meta tensors included, or anything with a
``shape``).  :func:`named` turns a spec tree into this rank's
placements (:class:`NamedSharding`: the mesh, the spec, and the block of
a global shape the rank holds); :func:`shard_tree` cuts a global tree to
this rank's blocks and :func:`gather_tree` joins the blocks back, the
per-rank counterparts of JAX's ``device_put`` under a sharding.

A mesh here is anything with ``shape`` (axis name → size) and
``axis_names``: :class:`AbstractMesh` for decisions alone, or
``launch.mesh.Mesh`` with its process groups.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

from ..core.ir import OpKind
from ..models.backbone import tree_map_with_path


class P(tuple):
    """A PartitionSpec: one entry per dim, each ``None`` (replicated), an
    axis name, or a tuple of axis names.  A one-name tuple is stored as the
    name, as JAX's ``PartitionSpec`` stores it, so specs compare equal to
    JAX's entry for entry."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, (tuple, list)) and len(e) == 1
            else tuple(e) if isinstance(e, list) else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape alone (no devices, no process groups): what
    :func:`shard_graph` and :func:`mesh_backend` read."""

    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...] = ("data", "model")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


class ShardingError(ValueError):
    """A graph cannot be partitioned as requested (a sharded dim reaches an
    op that needs it whole, or head counts do not divide the model axis).
    The message names the node."""


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    out = 1
    for a in axes:
        out *= mesh.shape[a]
    return out


def _div(size: int, n: int) -> bool:
    return n > 0 and size % n == 0


def shard_dim(mesh, size: int, axes):
    """``axes`` if ``size`` divides their product, else None (replicate)."""
    return axes if _div(size, axis_size(mesh, axes)) else None


def mesh_backend(backend, mesh):
    """The per-mesh view of a backend: the same ``name`` (impls and
    capabilities match unchanged) with a ``shard_tag`` qualifying every
    autotune-cache key.  Without it a per-shard bucket could alias a
    global one (a pow2 local shape IS some global bucket) and a mesh
    election would serve a single-device timing."""
    tag = "".join(f"{a}{mesh.shape[a]}" for a in mesh.axis_names)
    return dataclasses.replace(backend, shard_tag=tag)


def _entry(spec, i: int, rank: int):
    """The sharding of dim ``i`` (negative allowed) under ``spec``; a spec
    shorter than the rank replicates the trailing dims."""
    if i < 0:
        i += rank
    return spec[i] if 0 <= i < len(spec) else None


def _axes_tuple(e) -> Tuple[str, ...]:
    if e is None:
        return ()
    return (e,) if isinstance(e, str) else tuple(e)


def spec_axes(spec, dim: int, rank: int) -> Tuple[str, ...]:
    """The mesh axes that dim ``dim`` of a ``rank``-dim tensor is sharded
    over under ``spec`` (none where it is whole)."""
    return _axes_tuple(_entry(spec, dim, rank))


def local_shape(mesh, shape: Tuple[int, ...], spec) -> Tuple[int, ...]:
    return tuple(d // axis_size(mesh, _entry(spec, i, len(shape)))
                 for i, d in enumerate(shape))


_LOCAL_CHAIN = {OpKind.BIAS_ADD, OpKind.RELU, OpKind.GELU, OpKind.SILU,
                OpKind.SIGMOID, OpKind.TANH, OpKind.EXP, OpKind.SOFTPLUS,
                OpKind.SQRT, OpKind.SCALE, OpKind.SOFTCAP, OpKind.DROPOUT,
                OpKind.IDENTITY}
_ELEMENTWISE = _LOCAL_CHAIN - {OpKind.BIAS_ADD}


def shard_graph(g, mesh):
    """Partition a freshly extracted graph for ``mesh`` in place: every
    node gets a spec of its global shape, then its per-shard local shape;
    row-parallel products get ``attrs['psum_axes']``.  Every decision is
    guarded by divisibility and falls back to replication; a sharded dim
    reaching an op that needs it whole raises :class:`ShardingError`.
    Returns ``g`` with ``mesh``, ``input_specs``, ``output_specs`` and
    ``param_specs`` attached."""
    dp = dp_axes(mesh)
    m = "model" if "model" in mesh.axis_names else None
    mp = axis_size(mesh, m)
    spec: Dict[int, P] = {}
    cons = g.consumers()
    param_name = {id(n): name for name, n in g.params.items()}
    order = list(g.topo())

    def pspec(node) -> P:
        s = spec.get(id(node))
        if s is None:
            s = P(*([None] * len(node.spec.shape)))
            spec[id(node)] = s
        return s

    def ent(node, i):
        return _entry(pspec(node), i, len(node.spec.shape))

    # head-parallel attention needs every layer's query AND kv head counts
    # divisible by the model axis (a partly sharded q/k/v set would make
    # the attention node non-local)
    attn_tp = mp > 1
    for n in order:
        if n.op in (OpKind.ATTENTION, OpKind.DECODE_ATTENTION):
            heads = n.spec.shape[2]
            kv = n.inputs[1].spec.shape[2]
            if heads % mp or kv % mp:
                attn_tp = False

    def _col_ok(n) -> bool:
        """Column-sharding ``n``'s output features is legal when the shard
        stays local (bias, unary elementwise) until a row-parallel product
        folds it back, or until the graph's edge, where the output gather
        joins it (vocab-parallel head)."""
        cur = n
        while True:
            users = cons.get(cur, [])
            if not users:
                return cur in g.outputs
            if len(users) != 1:
                return False
            u = users[0]
            if u.op in _LOCAL_CHAIN:
                cur = u
                continue
            return (u.op in (OpKind.LINEAR, OpKind.MATMUL)
                    and u.inputs[0] is cur
                    and u.inputs[1].op is OpKind.PARAM
                    and _div(u.inputs[1].spec.size
                             // max(u.spec.shape[-1], 1), mp))

    def _attn_proj(n) -> bool:
        """``n`` is an attention q/k/v projection: its one consumer is a
        RESHAPE feeding ATTENTION / DECODE_ATTENTION."""
        users = cons.get(n, [])
        if len(users) == 1 and users[0].op is OpKind.RESHAPE:
            nxt = cons.get(users[0], [])
            return (len(nxt) == 1
                    and nxt[0].op in (OpKind.ATTENTION,
                                      OpKind.DECODE_ATTENTION))
        return False

    def _matmul(n):
        x, w = n.inputs[0], n.inputs[1]
        rank = len(x.spec.shape)
        sx = tuple(_entry(pspec(x), i, rank) for i in range(rank))
        xlast = sx[-1]
        out_dim = n.spec.shape[-1]
        # LINEAR params are stored (out, in); MATMUL weights are (in, out)
        oi = n.op is OpKind.LINEAR

        def wspec(in_ax, out_ax) -> P:
            return P(out_ax, in_ax) if oi else P(in_ax, out_ax)

        if w.op is not OpKind.PARAM:
            if xlast is not None or ent(w, 0) is not None:
                raise ShardingError(
                    f"{n.name}: contraction dim is sharded but the weight "
                    f"is not a parameter: no rule to row-parallelize it")
            spec[id(n)] = P(*(sx[: rank - 1] + (ent(w, -1),)))
            return
        have = spec.get(id(w))
        if xlast is not None:
            # row-parallel: the weight sharded on its input dim, partial
            # sums all-reduced over the contraction axes after this node
            want = wspec(xlast, None)
            if have is not None and have != want:
                raise ShardingError(
                    f"{n.name}: shared param "
                    f"{param_name.get(id(w), w.name)!r} already sharded as "
                    f"{have}, row-parallel use needs {want}")
            spec[id(w)] = want
            n.attrs["psum_axes"] = _axes_tuple(xlast)
            spec[id(n)] = P(*(sx[: rank - 1] + (None,)))
            return
        col = False
        if m is not None and have is None and _div(out_dim, mp):
            col = attn_tp if _attn_proj(n) else _col_ok(n)
        if col:
            spec[id(w)] = wspec(None, m)
            spec[id(n)] = P(*(sx[: rank - 1] + (m,)))
        else:
            if have is None:
                spec[id(w)] = wspec(None, None)
            out_ax = _entry(spec[id(w)], 0 if oi else -1,
                            len(w.spec.shape))
            spec[id(n)] = P(*(sx[: rank - 1] + (out_ax,)))

    def _reshape(n):
        src = n.inputs[0]
        a, b = src.spec.shape, tuple(n.attrs["shape"])
        sin = pspec(src)
        ra = len(a)
        if len(b) == ra + 1 and a[:-1] == b[:-2] and a[-1] == b[-2] * b[-1]:
            # split the last dim, (B,S,H·hd) → (B,S,H,hd): a feature shard
            # holds whole heads (attn_tp), so the shard moves to the heads
            spec[id(n)] = P(*(tuple(_entry(sin, i, ra) for i in range(ra))
                              + (None,)))
            return
        if len(b) == ra - 1 and a[:-2] == b[:-1] and b[-1] == a[-2] * a[-1]:
            # merge the last two dims, (B,S,H,hd) → (B,S,H·hd)
            if _entry(sin, -1, ra) is not None:
                raise ShardingError(
                    f"{n.name}: cannot merge a sharded trailing dim")
            spec[id(n)] = P(*tuple(_entry(sin, i, ra)
                                   for i in range(ra - 1)))
            return
        if any(_entry(sin, i, ra) is not None for i in range(ra)
               if not (i == 0 and b and b[0] == a[0])):
            raise ShardingError(
                f"{n.name}: general reshape of a sharded tensor "
                f"({a} → {b} under {sin}) has no propagation rule")
        lead = _entry(sin, 0, ra) if b and a and b[0] == a[0] else None
        spec[id(n)] = P(*((lead,) + (None,) * (len(b) - 1)))

    def _attention(n):
        head_ents = {ent(q, 2) for q in n.inputs if len(q.spec.shape) == 4}
        if len(head_ents) > 1:
            raise ShardingError(
                f"{n.name}: inconsistent head sharding across operands "
                f"({head_ents}): the model axis must divide every layer's "
                f"n_heads and n_kv_heads, or none")
        spec[id(n)] = pspec(n.inputs[0])

    for n in order:
        op = n.op
        shape = n.spec.shape
        rank = len(shape)
        if op is OpKind.INPUT:
            bspec = shard_dim(mesh, shape[0], dp) if rank else None
            if (rank == 4 and m is not None
                    and n.name.endswith(("k_cache", "v_cache"))):
                kv = shard_dim(mesh, shape[2], m) if attn_tp else None
                spec[id(n)] = P(bspec, None, kv, None)
            else:
                spec[id(n)] = P(*((bspec,) + (None,) * (rank - 1)))
            continue
        if op in (OpKind.PARAM, OpKind.CONST):
            continue           # params: set by their consumers; consts: replicated
        if op in (OpKind.LINEAR, OpKind.MATMUL):
            _matmul(n)
        elif op is OpKind.RESHAPE:
            _reshape(n)
        elif op in (OpKind.ATTENTION, OpKind.DECODE_ATTENTION):
            _attention(n)
        elif op is OpKind.BIAS_ADD:
            x, b = n.inputs[0], n.inputs[1]
            want = P(ent(x, n.attrs.get("axis", -1)))
            have = spec.get(id(b))
            if have is not None and have != want:
                raise ShardingError(
                    f"{n.name}: bias already sharded as {have}, needs {want}")
            spec[id(b)] = want
            spec[id(n)] = pspec(x)
        elif op in (OpKind.LAYERNORM, OpKind.RMSNORM):
            if ent(n.inputs[0], -1) is not None:
                raise ShardingError(
                    f"{n.name}: normalization over a model-sharded feature "
                    f"dim: insert the row-parallel product before the norm "
                    f"(serving graphs normalize replicated activations)")
            spec[id(n)] = pspec(n.inputs[0])
        elif op is OpKind.SOFTMAX:
            if ent(n.inputs[0], n.attrs.get("axis", -1)) is not None:
                raise ShardingError(f"{n.name}: softmax over a sharded axis")
            spec[id(n)] = pspec(n.inputs[0])
        elif op in _ELEMENTWISE:
            spec[id(n)] = pspec(n.inputs[0])
        elif op is OpKind.TIME_SHIFT:
            if ent(n.inputs[0], 1) is not None:
                raise ShardingError(f"{n.name}: shift along a sharded axis")
            spec[id(n)] = pspec(n.inputs[0])
        elif op in (OpKind.ADD, OpKind.SUB, OpKind.MUL, OpKind.DIV):
            out: List[Any] = []
            for i in range(rank):
                ents = []
                for inp in n.inputs:
                    off = rank - len(inp.spec.shape)
                    if i - off >= 0 and inp.spec.shape[i - off] > 1:
                        ents.append(ent(inp, i - off))
                if len(set(ents)) > 1:
                    raise ShardingError(
                        f"{n.name}: operands disagree on dim {i} sharding "
                        f"({ents})")
                out.append(ents[0] if ents else None)
            spec[id(n)] = P(*out)
        elif op is OpKind.TRANSPOSE:
            sin = pspec(n.inputs[0])
            ri = len(n.inputs[0].spec.shape)
            spec[id(n)] = P(*(_entry(sin, p, ri) for p in n.attrs["perm"]))
        elif op is OpKind.FLATTEN:
            if any(ent(n.inputs[0], i) is not None
                   for i in range(1, len(n.inputs[0].spec.shape))):
                raise ShardingError(f"{n.name}: flatten of a sharded tensor")
            spec[id(n)] = P(ent(n.inputs[0], 0), None)
        else:
            # batch-preserving default (convs, pools, scans): a
            # model-sharded operand has no rule here
            for inp in n.inputs:
                ri = len(inp.spec.shape)
                if any(_entry(pspec(inp), i, ri) is not None
                       for i in range(1, ri)):
                    raise ShardingError(
                        f"{n.name} ({op.value}): no sharding-propagation "
                        f"rule for a model-sharded operand")
            lead = ent(n.inputs[0], 0) if n.inputs and rank else None
            spec[id(n)] = P(*((lead,) + (None,) * max(rank - 1, 0)))

    # rewrite every node to its per-shard local shape
    for n in order:
        s = pspec(n)
        local = local_shape(mesh, n.spec.shape, s)
        if local != n.spec.shape:
            n.spec = dataclasses.replace(n.spec, shape=local)
        if n.op is OpKind.RESHAPE:
            n.attrs["shape"] = local
        if n.op is OpKind.LINEAR:
            f = axis_size(mesh, _entry(s, -1, len(local)))
            if f > 1:
                n.attrs["out_features"] = n.attrs["out_features"] // f

    g.mesh = mesh
    g.input_specs = [spec[id(i)] for i in g.inputs]
    g.output_specs = [pspec(o) for o in g.outputs]
    g.param_specs = {name: pspec(node) for name, node in g.params.items()}
    g.validate()
    return g


def column_parallel(g) -> Dict[int, Tuple[str, ...]]:
    """{id(product): axes} of the column-parallel products of a graph
    that :func:`shard_graph` partitioned, read from its ``param_specs``: a
    LINEAR or MATMUL with no ``psum_axes`` whose weight is sharded on its
    output dim (a LINEAR's (out, in) weight on dim 0, a MATMUL's (in, out)
    one on its last, as ``shard_graph`` lays them out), over ``axes`` (those
    of span one left out).  Its input is whole over ``axes`` and its
    output sharded over them, so the gradient each rank computes for
    that input through it is a partial sum over ``axes``."""
    name_of = {id(n): name for name, n in g.params.items()}
    out: Dict[int, Tuple[str, ...]] = {}
    for n in g.topo():
        if n.op not in (OpKind.LINEAR, OpKind.MATMUL) or len(n.inputs) < 2 \
                or n.attrs.get("psum_axes") or id(n.inputs[1]) not in name_of:
            continue
        w = n.inputs[1]
        rank = len(w.spec.shape)
        spec = g.param_specs[name_of[id(w)]]
        dim = 0 if n.op is OpKind.LINEAR else rank - 1
        axes = tuple(a for a in spec_axes(spec, dim, rank)
                     if axis_size(g.mesh, a) > 1)
        if axes:
            out[id(n)] = axes
    return out


def shard_slices(mesh, coords: Mapping[str, int], shape: Tuple[int, ...],
                 spec) -> Tuple[slice, ...]:
    """The index of this rank's block of a global ``shape`` under ``spec``:
    a dim sharded over axes (a1, a2, ...) splits into their product of
    blocks, row-major over the axes in the order the entry names them."""
    out = []
    for i, d in enumerate(shape):
        axes = _axes_tuple(_entry(spec, i, len(shape)))
        k, n = 0, 1
        for a in axes:
            k = k * mesh.shape[a] + coords[a]
            n *= mesh.shape[a]
        step = d // n
        out.append(slice(k * step, (k + 1) * step))
    return tuple(out)


# ---------------------------------------------------------------------------
# the backbone's parameter, batch and cache rules
# ---------------------------------------------------------------------------

# 2-D weights sharded on the output (column-parallel)
_COL = {"wq", "wk", "wv", "wg", "wu", "w_in", "w_gate", "ck", "cr",
        "xwq", "xwk", "xwv", "w1", "wr"}
# 2-D weights sharded on the input (row-parallel)
_ROW = {"wo", "wd", "w_out", "cv", "xwo", "w2"}
# 1-D tensors following a column-parallel output
_COL_BIAS = {"bq", "bk", "bv", "b1", "conv_b", "lam"}
_REPLICATED = {"gain", "bias", "bo", "b2", "router", "u", "w0",
               "gn_gain", "gn_bias", "enc_pos"}


def param_spec(mesh, cfg, path: Tuple[str, ...],
               shape: Tuple[int, ...]) -> P:
    """The spec of one backbone parameter by its name (``path[-1]``) and
    rank; a ``macro`` leaf's leading dim (the stack) is replicated."""
    name = path[-1]
    stacked = path[0] == "macro"
    lead = (None,) if stacked else ()
    body = shape[1:] if stacked else shape
    m = "model"

    def mk(*spec):
        return P(*(lead + spec))

    if "moe" in path[:-1]:
        if name == "router":
            return mk(None, None)
        # experts (E, D, F) / (E, F, D): expert-parallel on model
        return mk(shard_dim(mesh, body[0], m), None, None)
    if name == "embed":
        return P(shard_dim(mesh, shape[0], m), None)
    if name == "lm_head":
        return P(None, shard_dim(mesh, shape[1], m))
    if name in _COL and len(body) == 2:
        return mk(None, shard_dim(mesh, body[1], m))
    if name in _ROW and len(body) == 2:
        return mk(shard_dim(mesh, body[0], m), None)
    if name in ("conv_w", "wa", "wx"):     # (W, dr) and the (dr, dr) gates
        return mk(None, shard_dim(mesh, body[1], m))
    if name in _COL_BIAS and len(body) == 1:
        return mk(shard_dim(mesh, body[0], m))
    return mk(*(None,) * len(body))


def param_specs(mesh, cfg, params_tree) -> Any:
    """A :class:`P` tree matching a parameter(-shaped) tree."""
    return tree_map_with_path(
        lambda path, leaf: param_spec(mesh, cfg, tuple(str(k) for k in path),
                                      tuple(leaf.shape)), params_tree)


def batch_specs(mesh, cfg, batch_tree) -> Any:
    """Every batch leaf's leading dim on the data-parallel axes, where it
    divides them."""
    dp = dp_axes(mesh)

    def walk(path, leaf):
        b = shard_dim(mesh, leaf.shape[0], dp)
        return P(b, *(None,) * (len(leaf.shape) - 1))
    return tree_map_with_path(walk, batch_tree)


def cache_specs(mesh, cfg, cache_tree) -> Any:
    """KV caches: batch on data; KV heads on model where they divide it,
    else the sequence (flash-decoding); recurrent states: channels or
    heads on model."""
    dp = dp_axes(mesh)
    m = "model"

    def walk(path, leaf):
        names = [k if isinstance(k, str) else "" for k in path]
        stacked = bool(names) and names[0] == "macro"
        shape = tuple(leaf.shape[1:] if stacked else leaf.shape)
        lead = (None,) if stacked else ()

        def mk(*spec):
            return P(*(lead + spec))

        last = names[-1] if names else ""
        bspec = shard_dim(mesh, shape[0], dp)
        if last == "S":            # rwkv state (B, H, hd, hd)
            return mk(bspec, shard_dim(mesh, shape[1], m), None, None)
        if last == "h":            # rglru hidden (B, dr)
            return mk(bspec, shard_dim(mesh, shape[1], m))
        if last == "conv":         # (B, W-1, dr)
            return mk(bspec, None, shard_dim(mesh, shape[2], m))
        if last in ("last_x", "last_xc"):
            return mk(bspec, None)
        if len(shape) == 4:        # attention kv cache (B, S, KV, hd)
            kv_ax = shard_dim(mesh, shape[2], m)
            if kv_ax is not None:
                return mk(bspec, None, kv_ax, None)
            return mk(bspec, shard_dim(mesh, shape[1], m), None, None)
        return mk(bspec, *(None,) * (len(shape) - 1))
    return tree_map_with_path(walk, cache_tree)


# ---------------------------------------------------------------------------
# placements: this rank's blocks of a tree
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``): which block of a global
    array this rank of ``mesh`` holds."""

    mesh: Any
    spec: P

    def index(self, shape: Tuple[int, ...]) -> Tuple[slice, ...]:
        """This rank's block of a global ``shape``."""
        coords = getattr(self.mesh, "coords", None)
        if coords is None:
            raise ValueError(f"{self.mesh!r} has no ranks to place on")
        return shard_slices(self.mesh, coords, tuple(shape), self.spec)

    def shard(self, x):
        """This rank's block of the global ``x`` (a copy of its own)."""
        return x[self.index(x.shape)].clone()

    def gather(self, x):
        """The global array from every rank's block ``x``: each sharded
        dim all-gathered over its axes (a collective: every rank of the
        mesh calls it, in one order)."""
        for dim in range(x.dim()):
            axes = _axes_tuple(_entry(self.spec, dim, x.dim()))
            if axes and axis_size(self.mesh, axes) > 1:
                x = self.mesh.all_gather(x, axes, dim)
        return x


def named(mesh, spec_tree) -> Any:
    """The :class:`NamedSharding` of every spec of ``spec_tree`` on
    ``mesh``."""
    if isinstance(spec_tree, P):
        return NamedSharding(mesh, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (tuple, list)):
        return type(spec_tree)(named(mesh, v) for v in spec_tree)
    raise TypeError(f"named: not a spec tree: {spec_tree!r}")


def _zip_specs(fn, tree, spec_tree):
    """``fn(leaf, spec)`` over a tree and its spec tree (a spec is a leaf
    there, though it is a tuple)."""
    if isinstance(spec_tree, P):
        return fn(tree, spec_tree)
    if isinstance(tree, dict):
        return {k: _zip_specs(fn, v, spec_tree[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_zip_specs(fn, v, s)
                          for v, s in zip(tree, spec_tree))
    raise TypeError(f"no spec for leaf {tree!r}")


def shard_tree(mesh, tree, spec_tree, device: Optional[Any] = None) -> Any:
    """This rank's block of every leaf of the global ``tree`` (tensors),
    each a copy of its own, on ``device`` (default: the mesh's)."""
    dev = device if device is not None else getattr(mesh, "device", None)

    def cut(x, spec):
        out = NamedSharding(mesh, spec).shard(x)
        return out if dev is None else out.to(dev)
    return _zip_specs(cut, tree, spec_tree)


def gather_tree(mesh, tree, spec_tree) -> Any:
    """The global tree from every rank's blocks (a collective)."""
    return _zip_specs(lambda x, spec: NamedSharding(mesh, spec).gather(x),
                      tree, spec_tree)
