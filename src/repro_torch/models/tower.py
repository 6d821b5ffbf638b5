"""Composable member-tower factory of the PyTorch port, the counterpart
of the JAX package's ``repro/models/tower.py`` (DESIGN.md §12).

The spec layer (``TowerSpec``, ``parse_block``, ``check_blocks``,
``resolve``, ``mlp_tower``, ``legacy_dims_tower``) is the JAX package's,
copied as it is, so one tower DSL string resolves to the same dicts in
both packages. The param trees keep the JAX package's layout: one list
entry per block; an ``mlp`` block a list of ``{'w', 'b'}`` with ``w``
shaped (in, out) and applied as ``x @ w``; ``embed`` ``{'w', 'table',
'pos'}``; ``attn_block`` ``{ln1, wq, wk, wv, wo, ln2, w1, b1, w2, b2}``;
``quantize`` ``{}``. :func:`from_numpy` loads a JAX-made tree (as numpy)
into that layout, so one checkpoint drives either package.

``init`` draws from an explicit ``torch.Generator`` (the JAX package's
``jax.random`` stream cannot be reproduced) and places the tree on an
explicit ``device``. ``apply`` is the forward pass: ``attn_block`` runs
the hand-written flash-attention kernel and ``quantize`` the
hand-written int8 kernel on a CUDA tensor, their plain versions on a
CPU tensor (``kernel=auto|pallas|ref``, see ``kernels/ops.py``). Both
are ``torch.autograd.Function``s with the JAX package's ``custom_vjp``
contracts: attention's backward is the VJP of the plain attention at
the saved q, k, v, which on a CUDA tensor the backward kernel computes
(the JAX package differentiates ``attention_ref``: the TPU has no
backward kernel), the quantizer's is the identity (straight-through).

Sharding (``logical_axes``, ``make_tower_rules``, ``shard_tower``,
``apply(..., rules)``) is explicit tensor parallelism over the mesh's
``model`` axis, placed as the logical axes resolve: the columns of
``wq/wk/wv``, ``w1/b1`` and of every mlp layer's ``w`` and ``b`` split,
the rows of ``wo`` and ``w2`` split with their partial products summed
(``psum``), the embed table split over ``vocab``, each where its width
divides; the rest stays whole on the first model position's device,
where the activations between blocks live. A split param is a
:class:`Shards` leaf (one part a position), so the member's backward
differentiates each part and its SGD step updates it in place of the
whole, as the JAX package's runs through the same rules.
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.launch import mesh as M
from repro_torch.models.params import resolve_device
from repro_torch.sharding.rules import MeshRules, is_axes, map_in_tree_order

BLOCK_KINDS = ("embed", "attn_block", "quantize", "mlp")

# embed-block bucketization: chunk means of standardized features live
# almost entirely in [-2.5, 2.5]; that range maps linearly onto the
# bucket grid and the ends clip.
_BUCKET_SPAN = 5.0

BlockLike = Union[str, Dict[str, Any]]


# ---------------------------------------------------------------------------
# spec parsing / resolution
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TowerSpec:
    """A resolved tower: normalized block dicts + concrete widths.

    Produced by :func:`resolve` (or the :func:`mlp_tower` /
    :func:`legacy_dims_tower` helpers) — block dicts here always carry
    every hyperparameter explicitly, so ``init``/``apply`` never apply
    defaults.
    """

    blocks: Tuple[Dict[str, Any], ...]
    in_dim: int
    out_dim: int

    @property
    def kinds(self) -> Tuple[str, ...]:
        return tuple(b["kind"] for b in self.blocks)


def parse_block(block: BlockLike) -> Dict[str, Any]:
    """Normalize one block config (string DSL or dict) to a plain dict.

    Strings look like ``"mlp:hidden=64|32"`` or ``"attn_block:heads=4"``;
    ``|`` separates tuple elements, values parse as int when possible.
    """
    if isinstance(block, dict):
        out = dict(block)
        if "kind" not in out:
            raise ValueError(f"tower block {block!r} has no 'kind'")
    elif isinstance(block, str):
        head, _, rest = block.partition(":")
        out = {"kind": head.strip()}
        if rest.strip():
            for item in rest.split(","):
                if "=" not in item:
                    raise ValueError(
                        f"tower block {block!r}: expected key=val, got "
                        f"{item!r}")
                k, _, v = item.partition("=")
                out[k.strip()] = _parse_val(v.strip())
    else:
        raise ValueError(f"tower block must be str or dict, got "
                         f"{type(block).__name__}")
    kind = out["kind"]
    if kind == "attn":               # common shorthand
        kind = out["kind"] = "attn_block"
    if kind not in BLOCK_KINDS:
        raise ValueError(f"unknown tower block kind {kind!r} "
                         f"(expected one of {BLOCK_KINDS})")
    return out


def _parse_val(v: str) -> Any:
    if "|" in v:
        return tuple(_parse_val(e) for e in v.split("|"))
    try:
        return int(v)
    except ValueError:
        return v


_BLOCK_KEYS = {
    "embed": {"tokens", "dim", "buckets"},
    "attn_block": {"heads", "mlp", "kernel"},
    "quantize": {"kernel"},
    "mlp": {"hidden", "final_act"},
}


def check_blocks(blocks: Sequence[BlockLike]) -> List[Dict[str, Any]]:
    """Validate block structure without knowing concrete widths.

    Used by the cluster-spec validator, where ``in_dim`` depends on the
    data provider and is not yet known. Returns the parsed dicts.
    Raises ``ValueError`` on malformed chains.
    """
    if not blocks:
        raise ValueError("tower must have at least one block")
    parsed = [parse_block(b) for b in blocks]
    for i, b in enumerate(parsed):
        kind = b["kind"]
        extra = set(b) - {"kind"} - _BLOCK_KEYS[kind]
        if extra:
            raise ValueError(
                f"tower block {i} ({kind}): unknown keys {sorted(extra)}")
        if kind == "embed" and i != 0:
            raise ValueError("'embed' must be the first tower block")
        if kind == "attn_block":
            if not parsed[:i] or parsed[0]["kind"] != "embed":
                raise ValueError(
                    "'attn_block' needs an 'embed' block first "
                    "(attention runs on the token sequence it "
                    "produces)")
            if any(p["kind"] == "mlp" for p in parsed[:i]):
                raise ValueError(
                    "'attn_block' must come before any 'mlp' block — "
                    "'mlp' mean-pools the token sequence to flat "
                    "features, leaving no sequence to attend over")
        if b.get("kernel", "auto") not in ("auto", "pallas", "ref"):
            raise ValueError(
                f"tower block {i} ({kind}): kernel must be "
                f"auto|pallas|ref, got {b.get('kernel')!r}")
    last_real = [b for b in parsed if b["kind"] != "quantize"]
    if not last_real or last_real[-1]["kind"] != "mlp":
        raise ValueError(
            "the last (non-quantize) tower block must be 'mlp' — it "
            "owns the output width")
    return parsed


def resolve(blocks: Sequence[BlockLike], in_dim: int,
            out_dim: int) -> TowerSpec:
    """Resolve block configs + concrete widths into a :class:`TowerSpec`.

    Fills every default, threads widths through the chain, and
    validates shape compatibility (e.g. ``dim % heads == 0``).
    """
    parsed = check_blocks(blocks)
    resolved: List[Dict[str, Any]] = []
    width = int(in_dim)               # current feature width (last axis)
    seq = 0                           # current token count (0 = flat 2-D)
    for i, b in enumerate(parsed):
        kind = b["kind"]
        if kind == "embed":
            tokens = int(b.get("tokens", 8))
            dim = int(b.get("dim", 32))
            buckets = int(b.get("buckets", 32))
            if tokens < 1 or dim < 1 or buckets < 2:
                raise ValueError(
                    f"embed block: tokens/dim >= 1 and buckets >= 2 "
                    f"required, got {tokens}/{dim}/{buckets}")
            chunk = max(1, math.ceil(width / tokens))
            resolved.append({"kind": "embed", "tokens": tokens,
                             "dim": dim, "buckets": buckets,
                             "chunk": chunk, "in_dim": width})
            width, seq = dim, tokens
        elif kind == "attn_block":
            heads = int(b.get("heads", 4))
            ff = int(b.get("mlp", 4 * width))
            if width % heads != 0:
                raise ValueError(
                    f"attn_block: dim {width} not divisible by "
                    f"heads {heads}")
            resolved.append({"kind": "attn_block", "heads": heads,
                             "mlp": ff, "dim": width, "seq": seq,
                             "kernel": b.get("kernel", "auto")})
        elif kind == "quantize":
            resolved.append({"kind": "quantize",
                             "kernel": b.get("kernel", "auto")})
        else:  # mlp
            hidden = b.get("hidden", ())
            if isinstance(hidden, int):
                hidden = (hidden,)
            hidden = tuple(int(h) for h in hidden)
            dims = (width,) + hidden + (int(out_dim),)
            resolved.append({"kind": "mlp", "dims": dims,
                             "final_act": bool(b.get("final_act",
                                                     True))})
            width, seq = int(out_dim), 0
    return TowerSpec(blocks=tuple(resolved), in_dim=int(in_dim),
                     out_dim=int(out_dim))


def mlp_tower(in_dim: int, hidden: Sequence[int], out_dim: int,
              final_act: bool = True) -> TowerSpec:
    """The legacy MLP as a one-block tower (bit-identical params/math)."""
    return resolve(({"kind": "mlp", "hidden": tuple(hidden),
                     "final_act": final_act},), in_dim, out_dim)


_warned_dims = False


def legacy_dims_tower(dims: Sequence[int],
                      final_act: bool = True) -> TowerSpec:
    """Deprecated-compat shim: a ``bottom_dims``/``top_dims`` tuple as
    an equivalent one-block MLP tower. Warns once per process."""
    global _warned_dims
    if not _warned_dims:
        _warned_dims = True
        warnings.warn(
            "bottom_dims/top_dims tuples are deprecated; express the "
            "model as a TowerSpec (repro.models.tower) instead",
            DeprecationWarning, stacklevel=2)
    dims = tuple(int(d) for d in dims)
    if len(dims) < 2:
        raise ValueError(f"need >= 2 dims, got {dims}")
    return mlp_tower(dims[0], dims[1:-1], dims[-1], final_act=final_act)



# ---------------------------------------------------------------------------
# kernels: hand-written CUDA forward, plain PyTorch version on the CPU;
# the backward passes of the JAX package's custom_vjp rules
# ---------------------------------------------------------------------------


def _attention(q, k, v, kernel: str = "ref"):
    """Bidirectional multi-head attention, (b, h, s, dh) layout. Under
    grad, for every ``kernel`` but ``"ref"``, ``FlashAttention``: the
    forward kernel with each row's log-sum-exp and the backward kernel as
    its gradient; on a CPU tensor both are the plain versions, the
    backward the plain attention's VJP, as the JAX package's
    ``_attention_bwd`` (``attention_ref`` under ``jax.vjp``). Outside
    grad the forward alone; ``"ref"`` differentiates ``attention_ref``."""
    if kernel == "ref":
        return ref.attention_ref(q, k, v, causal=False)
    ops.check_kernel(kernel, q, "flash_attention")
    if ops.needs_grad(q, k, v):
        return fa.FlashAttention.apply(q, k, v, False, 0, None)
    return fa.flash_attention(q, k, v, causal=False)


class _FakeQuant(torch.autograd.Function):
    """Per-row int8 quantize then dequantize; the gradient passes
    straight through."""

    @staticmethod
    def forward(ctx, x, kernel):
        shape = x.shape
        q, scale = ops.quantize_int8(x.reshape(-1, shape[-1]).contiguous(),
                                     kernel=kernel)
        return (q.float() * scale[:, None]).to(x.dtype).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        return g, None


def fake_quant(x, kernel: str = "ref"):
    """Straight-through int8 fake-quantization (per-row symmetric) on
    the wire codec's grid: quantize, then dequantize; identity
    backward."""
    return _FakeQuant.apply(x, kernel)


# ---------------------------------------------------------------------------
# init / apply
# ---------------------------------------------------------------------------


def init(spec: TowerSpec, generator: torch.Generator,
         device: Union[str, torch.device] = "cuda") -> List[Any]:
    """Initialize tower params: one entry per block, drawn on the CPU
    from ``generator`` (the same tree on every device) and placed on
    ``device`` (a CUDA device on a machine without one raises). Same
    distributions as the JAX package's ``init``."""
    dev = resolve_device(device)
    return [_to(_BLOCK_INIT[b["kind"]](b, generator), dev)
            for b in spec.blocks]


def _normal(g: torch.Generator, *shape: int) -> torch.Tensor:
    return torch.randn(shape, generator=g, dtype=torch.float32)


def _init_mlp(b, g):
    dims = b["dims"]
    return [{"w": _normal(g, a, o) / np.sqrt(a),
             "b": torch.zeros(o, dtype=torch.float32)}
            for a, o in zip(dims[:-1], dims[1:])]


def _init_embed(b, g):
    t, c, d, nb = b["tokens"], b["chunk"], b["dim"], b["buckets"]
    return {"w": _normal(g, t, c, d) / np.sqrt(c),
            "table": 0.02 * _normal(g, t * nb, d),
            "pos": 0.02 * _normal(g, t, d)}


def _init_attn(b, g):
    d, f = b["dim"], b["mlp"]
    return {"ln1": torch.ones(d, dtype=torch.float32),
            "wq": _normal(g, d, d) / np.sqrt(d),
            "wk": _normal(g, d, d) / np.sqrt(d),
            "wv": _normal(g, d, d) / np.sqrt(d),
            "wo": _normal(g, d, d) / np.sqrt(d),
            "ln2": torch.ones(d, dtype=torch.float32),
            "w1": _normal(g, d, f) / np.sqrt(d),
            "b1": torch.zeros(f, dtype=torch.float32),
            "w2": _normal(g, f, d) / np.sqrt(f),
            "b2": torch.zeros(d, dtype=torch.float32)}


_BLOCK_INIT = {"mlp": _init_mlp, "embed": _init_embed,
               "attn_block": _init_attn,
               "quantize": lambda b, g: {}}


@dataclass
class Shards:
    """A param split along ``dim`` over the mesh's ``model`` axis:
    ``parts[i]`` lives on model position i's device."""

    parts: List[torch.Tensor]
    dim: int

    def gather(self, device) -> torch.Tensor:
        return M.all_gather(self.parts, self.dim, device)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    if isinstance(tree, Shards):
        return Shards([fn(t) for t in tree.parts], tree.dim)
    return fn(tree)


def leaves(tree) -> List[Any]:
    """The tree's tensors (each part of a :class:`Shards`), in the order
    :func:`with_leaves` takes."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    if isinstance(tree, Shards):
        return list(tree.parts)
    return [tree]


def _to(tree, device):
    return _tree_map(lambda t: t.to(device), tree)


def with_leaves(tree, values: Sequence[torch.Tensor]) -> List[Any]:
    """The tree with its tensors replaced by ``values``, in
    :func:`leaves`' order."""
    it = iter(values)
    return _tree_map(lambda _: next(it), list(tree))


def from_numpy(params, device: Union[str, torch.device] = "cuda"
               ) -> List[Any]:
    """A param tree of numpy arrays (a JAX-made tree through
    ``np.asarray``, or a checkpoint) as tensors on ``device``, in the
    same layout. Values are copied, never reinterpreted."""
    dev = resolve_device(device)
    return _tree_map(
        lambda a: torch.as_tensor(np.array(a, copy=True)).to(dev),
        list(params))


def _whole(tree, device=None):
    """The tree with each :class:`Shards` gathered into one tensor (on
    ``device``, else the first part's)."""
    if isinstance(tree, dict):
        return {k: _whole(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_whole(v, device) for v in tree]
    if isinstance(tree, Shards):
        return tree.gather(device or tree.parts[0].device)
    return tree


def to_numpy(params) -> List[Any]:
    """The inverse of :func:`from_numpy`: the tree as numpy arrays (a
    sharded tree gathered whole)."""
    return _tree_map(lambda t: t.detach().cpu().numpy(),
                     _whole(list(params), "cpu"))


def apply(spec: TowerSpec, params: Sequence[Any], x: torch.Tensor,
          rules=None) -> torch.Tensor:
    """Forward pass of the tower on ``x`` (batch, in_dim). With
    ``rules`` (a ``MeshRules`` of :func:`make_tower_rules`) ``params``
    is :func:`shard_tower`'s placement and each split param runs tensor
    parallel over the mesh's model axis; the result is on the first
    model position's device."""
    if rules is not None:
        x = x.to(rules.mesh.axis_devices("model")[0])
    for b, p in zip(spec.blocks, params):
        x = _BLOCK_APPLY[b["kind"]](b, p, x)
    return x


# ---------------------------------------------------------------------------
# tensor parallelism: the activations between blocks are whole on the
# first model position's device, with every param that is not split; a
# split param (:class:`Shards`) computes each position's share with its
# part on its device, and the shares are combined on the activations'
# ---------------------------------------------------------------------------


def _devices(w: Shards) -> List[torch.device]:
    return [t.device for t in w.parts]


def _split(x: torch.Tensor, dim: int, devs) -> List[torch.Tensor]:
    """``x`` cut into ``len(devs)`` equal chunks along ``dim``, chunk i
    on ``devs[i]``."""
    return [c.to(d) for c, d in zip(x.chunk(len(devs), dim), devs)]


def _cols(x: torch.Tensor, w: Shards, bias=None) -> List[torch.Tensor]:
    """Each position's columns of ``x @ w (+ bias)``: ``w`` (and
    ``bias``) split over their last dim."""
    out = [xi @ wi for xi, wi in zip(M.broadcast(x, _devices(w)), w.parts)]
    if bias is not None:
        out = [o + bi for o, bi in zip(out, bias.parts)]
    return out


def _dense(x: torch.Tensor, w, bias) -> torch.Tensor:
    """``x @ w + bias``; a column-split ``w`` gathers its columns."""
    if isinstance(w, Shards):
        return M.all_gather(_cols(x, w, bias), -1, x.device)
    return x @ w + bias


def _row_sum(hs: Sequence[torch.Tensor], w: Shards, device) -> torch.Tensor:
    """``concat(hs) @ w`` for a row-split ``w``: the positions' partial
    products summed (``psum``)."""
    return M.psum([hi @ wi for hi, wi in zip(hs, w.parts)], device)


def _apply_mlp(b, p, x):
    if x.dim() == 3:                  # sequence -> pooled features
        x = x.mean(dim=1)
    n = len(p)
    for i, layer in enumerate(p):
        x = _dense(x, layer["w"], layer["b"])
        if i < n - 1 or b["final_act"]:
            x = torch.relu(x)
    return x


def embed_buckets(b, x):
    """The embed block's chunks (n, tokens, chunk) of ``x`` and their
    bucket ids (n, tokens). The padding zeros count in the chunk mean,
    as in the JAX package; f32 arithmetic, then truncation toward zero,
    then the clip."""
    t, c, nb = b["tokens"], b["chunk"], b["buckets"]
    pad = t * c - x.shape[-1]
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    xr = x.reshape(x.shape[0], t, c)
    mean = xr.mean(dim=-1)
    ids = ((mean + _BUCKET_SPAN / 2) * (nb / _BUCKET_SPAN)) \
        .to(torch.int32).clamp(0, nb - 1)
    return xr, ids


def _apply_embed(b, p, x):
    t, nb = b["tokens"], b["buckets"]
    xr, ids = embed_buckets(b, x)
    w = p["w"]
    if isinstance(w, Shards):
        val = M.all_gather([torch.einsum("ntc,tcd->ntd", xi, wi) for xi, wi
                            in zip(M.broadcast(xr, _devices(w)), w.parts)],
                           -1, x.device)
    else:
        val = torch.einsum("ntc,tcd->ntd", xr, w)
    rows = (torch.arange(t, device=x.device)[None, :] * nb + ids).long()
    return val + _lookup(p["table"], rows) + p["pos"][None, :, :]


def _lookup(table, rows: torch.Tensor) -> torch.Tensor:
    """``table[rows]``; a table split over its rows has each position
    look up the rows it holds, the others adding zero."""
    if not isinstance(table, Shards):
        return table[rows]
    looks = []
    lo = 0
    for tab in table.parts:
        r = rows.to(tab.device) - lo
        hit = (r >= 0) & (r < tab.shape[0])
        looks.append(tab[r.clamp(0, tab.shape[0] - 1)]
                     * hit[..., None].to(tab.dtype))
        lo += tab.shape[0]
    return M.psum(looks, rows.device)


def _rmsnorm(scale, x, eps: float = 1e-5):
    var = x.square().mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * scale


def _heads(z: torch.Tensor, h: int) -> torch.Tensor:
    """(n, t, h * dh) -> (n, h, t, dh), the flash-attention layout; the
    kernel takes contiguous tensors."""
    n, t, d = z.shape
    return z.reshape(n, t, h, d // h).transpose(1, 2).contiguous()


def _merge_heads(o: torch.Tensor) -> torch.Tensor:
    """(n, h, t, dh) -> (n, t, h * dh)."""
    n, h, t, dh = o.shape
    return o.transpose(1, 2).reshape(n, t, h * dh)


def _attn_out(b, p, y):
    """Attention of the normed ``y``, through ``wo``. Column-split
    q/k/v: whole heads attend on their own position, or, where a
    position's columns cut a head, the heads gather, attend whole and
    hand each position its columns back; the row-split ``wo``'s partial
    products are summed."""
    h = b["heads"]
    if not isinstance(p["wq"], Shards):
        o = _attention(_heads(y @ p["wq"], h), _heads(y @ p["wk"], h),
                       _heads(y @ p["wv"], h), b["kernel"])
        return _merge_heads(o) @ p["wo"]
    devs = _devices(p["wq"])
    m = len(devs)
    qkv = [_cols(y, p[w]) for w in ("wq", "wk", "wv")]
    if h % m == 0:
        os_ = [_merge_heads(_attention(_heads(qi, h // m), _heads(ki, h // m),
                                       _heads(vi, h // m), b["kernel"]))
               for qi, ki, vi in zip(*qkv)]
    else:
        q, k, v = (_heads(M.all_gather(z, -1, y.device), h) for z in qkv)
        os_ = _split(_merge_heads(_attention(q, k, v, b["kernel"])), -1,
                     devs)
    return _row_sum(os_, p["wo"], y.device)


def _apply_attn(b, p, x):
    y = _rmsnorm(p["ln1"], x)
    x = x + _attn_out(b, p, y)
    y = _rmsnorm(p["ln2"], x)
    if isinstance(p["w1"], Shards):
        hs = [torch.relu(z) for z in _cols(y, p["w1"], p["b1"])]
        y = _row_sum(hs, p["w2"], x.device) + p["b2"]
    else:
        y = torch.relu(y @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
    return x + y


def _apply_quant(b, p, x):
    return fake_quant(x, b["kernel"])


_BLOCK_APPLY = {"mlp": _apply_mlp, "embed": _apply_embed,
                "attn_block": _apply_attn, "quantize": _apply_quant}


# ---------------------------------------------------------------------------
# sharding
# ---------------------------------------------------------------------------


def logical_axes(spec: TowerSpec) -> List[Any]:
    """Per-param logical axis names, matching the ``init`` tree."""
    axes: List[Any] = []
    for b in spec.blocks:
        kind = b["kind"]
        if kind == "mlp":
            axes.append([{"w": ("embed", "mlp"), "b": ("mlp",)}
                         for _ in range(len(b["dims"]) - 1)])
        elif kind == "embed":
            axes.append({"w": (None, None, "mlp"),
                         "table": ("vocab", None),
                         "pos": (None, None)})
        elif kind == "attn_block":
            axes.append({"ln1": (None,),
                         "wq": ("embed", "heads"),
                         "wk": ("embed", "heads"),
                         "wv": ("embed", "heads"),
                         "wo": ("heads", "embed"),
                         "ln2": (None,),
                         "w1": ("embed", "mlp"), "b1": ("mlp",),
                         "w2": ("mlp", "embed"), "b2": (None,)})
        else:
            axes.append({})
    return axes


def make_tower_rules(shard: int, devices=None, device=None):
    """MeshRules for an N-way model-parallel tower, or None when
    ``shard <= 1`` (the common unsharded path). The mesh is ``data 1 x
    model shard`` over ``devices`` when given (a device may repeat:
    ``["cuda:0"] * 2`` runs both shards on one card), else over the
    first ``shard`` distinct local devices of ``device``'s type (CUDA
    by default): a ``ValueError`` naming the count when there are
    fewer."""
    if shard <= 1:
        return None
    if devices is None:
        kind = torch.device(device if device is not None else "cuda").type
        have = ([torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
                if kind == "cuda" else [torch.device(kind)])
        if len(have) < shard:
            name = "CUDA" if kind == "cuda" else kind
            raise ValueError(
                f"tower_shard={shard} but only {len(have)} local {name} "
                f"device(s); pass devices= to place several shards on "
                f"one device")
        devices = have[:shard]
    return MeshRules(mesh=M.make_local_mesh(1, shard, devices))


def shard_tower(params: Sequence[Any], spec: TowerSpec, rules):
    """Place tower params per their logical axes (no-op without rules):
    a leaf whose spec names ``model`` becomes a :class:`Shards` of
    contiguous parts, one on each model position's device; every other
    leaf goes whole to the first model position's device."""
    if rules is None:
        return list(params)
    mesh = rules.mesh
    if any(size > 1 for ax, size in mesh.shape.items() if ax != "model"):
        raise ValueError(f"a tower shards over the model axis only; the "
                         f"mesh is {mesh.shape}")
    devs = mesh.axis_devices("model")

    def place(ax, t):
        t = _whole(t, devs[0])
        spec_ = rules.param_spec(ax, tuple(t.shape))
        for dim, part in enumerate(spec_):
            if part == "model":
                return Shards([c.clone(memory_format=torch.contiguous_format)
                               for c in _split(t.detach(), dim, devs)], dim)
        return t.detach().to(devs[0])

    return map_in_tree_order(place, logical_axes(spec), list(params),
                             is_leaf=is_axes)


# ---------------------------------------------------------------------------
# analytic cost (roofline)
# ---------------------------------------------------------------------------


def tower_flops(spec: TowerSpec, batch: int) -> float:
    """Analytic forward FLOPs (matmuls only; 2*M*N*K per GEMM)."""
    fl = 0.0
    n = float(batch)
    for b in spec.blocks:
        if b["kind"] == "mlp":
            dims = b["dims"]
            fl += sum(2.0 * n * a * o
                      for a, o in zip(dims[:-1], dims[1:]))
        elif b["kind"] == "embed":
            fl += 2.0 * n * b["tokens"] * b["chunk"] * b["dim"]
        elif b["kind"] == "attn_block":
            t, d, f = b["seq"], b["dim"], b["mlp"]
            fl += 8.0 * n * t * d * d          # qkv + out projections
            fl += 4.0 * n * t * t * d          # scores + weighted sum
            fl += 4.0 * n * t * d * f          # relu MLP
    return fl


def params_bytes(params) -> int:
    return int(sum(x.numel() * x.element_size() for x in leaves(params)))
