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
contracts: attention's backward is the VJP of the plain attention
recomputed from the saved q, k, v (the JAX package has no backward
kernel either), the quantizer's is the identity (straight-through).
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels import ops, ref
from repro_torch.models.params import resolve_device

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


class _Attention(torch.autograd.Function):
    """Bidirectional attention through ``ops.flash_attention``; its
    backward is the plain attention's VJP at the saved inputs, as the
    JAX package's ``_attention_bwd`` (``attention_ref`` under
    ``jax.vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, kernel):
        ctx.save_for_backward(q, k, v)
        return ops.flash_attention(q, k, v, causal=False, kernel=kernel)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = ref.attention_ref(q, k, v, causal=False)
        return (*torch.autograd.grad(out, (q, k, v), g), None)


def _attention(q, k, v, kernel: str = "ref"):
    """Bidirectional multi-head attention, (b, h, s, dh) layout."""
    return _Attention.apply(q, k, v, kernel)


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


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def leaves(tree) -> List[Any]:
    """The tree's tensors, in the order :func:`with_leaves` takes."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
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


def to_numpy(params) -> List[Any]:
    """The inverse of :func:`from_numpy`: the tree as numpy arrays."""
    return _tree_map(lambda t: t.detach().cpu().numpy(), list(params))


def apply(spec: TowerSpec, params: Sequence[Any], x: torch.Tensor
          ) -> torch.Tensor:
    """Forward pass of the tower on ``x`` (batch, in_dim)."""
    for b, p in zip(spec.blocks, params):
        x = _BLOCK_APPLY[b["kind"]](b, p, x)
    return x


def _apply_mlp(b, p, x):
    if x.dim() == 3:                  # sequence -> pooled features
        x = x.mean(dim=1)
    n = len(p)
    for i, layer in enumerate(p):
        x = x @ layer["w"] + layer["b"]
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
    val = torch.einsum("ntc,tcd->ntd", xr, p["w"])
    tok = torch.arange(t, device=x.device)[None, :] * nb
    look = p["table"][(tok + ids).long()]
    return val + look + p["pos"][None, :, :]


def _rmsnorm(scale, x, eps: float = 1e-5):
    var = x.square().mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * scale


def _apply_attn(b, p, x):
    n, t, d = x.shape
    h = b["heads"]
    dh = d // h
    y = _rmsnorm(p["ln1"], x)
    # (n, t, d) -> (n, h, t, dh) for the flash-attention layout; the
    # kernel takes contiguous tensors
    q = (y @ p["wq"]).reshape(n, t, h, dh).transpose(1, 2).contiguous()
    k = (y @ p["wk"]).reshape(n, t, h, dh).transpose(1, 2).contiguous()
    v = (y @ p["wv"]).reshape(n, t, h, dh).transpose(1, 2).contiguous()
    o = _attention(q, k, v, b["kernel"])
    o = o.transpose(1, 2).reshape(n, t, d) @ p["wo"]
    x = x + o
    y = _rmsnorm(p["ln2"], x)
    y = torch.relu(y @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
    return x + y


def _apply_quant(b, p, x):
    return fake_quant(x, b["kernel"])


_BLOCK_APPLY = {"mlp": _apply_mlp, "embed": _apply_embed,
                "attn_block": _apply_attn, "quantize": _apply_quant}


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
