"""VFL x LLM: the paper's technique applied to a model of the zoo, the
port of the JAX package's ``examples/vfl_llm.py``.

Two feature silos jointly train a granite-MoE backbone: each silo (a
``pod`` of the mesh) owns a front-end that turns its slice of the user
features into pseudo-token embeddings; the master owns the transformer
backbone and the labels. The exchange is mesh-mode VFL's
(``core/vfl_step.py``): each silo's embeddings get the pairwise masks of
``core/secure_agg``, the masked embeddings are summed onto the master's
device, and the backbone reads the sum as soft tokens through its stack,
final norm and ``lm_head``; the loss is the token cross-entropy plus
0.01 x the router's load-balance loss; plain SGD updates every party.

  PYTHONPATH=src python -m repro_torch.examples.vfl_llm [--device cpu]

The reduced config, 2 silos, batch 8, 16 soft tokens from 32 features a
silo, SGD at lr 0.05 for 8 steps, as the JAX example. ``--device``
defaults to ``cuda``; both silos' positions of the mesh are on that one
device (``launch/mesh.py``). ``vfl_llm_grads`` and ``make_vfl_llm_step``
drive any config (``chip_smoke.py`` runs the full-width model).
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, List, Sequence, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.core import secure_agg
from repro_torch.core.vfl_step import pod_devices
from repro_torch.launch.mesh import Mesh, make_mesh, psum
from repro_torch.models import layers
from repro_torch.models import params as PRM
from repro_torch.models import transformer as T

N_PARTIES, BATCH, D_FEAT, SEQ = 2, 8, 32, 16
LR, STEPS = 0.05, 8
LOAD_BALANCE_WEIGHT = 0.01


def silo_mesh(device, n_parties: int = N_PARTIES) -> Mesh:
    """A ``pod`` axis of one position a silo, all on ``device``."""
    return make_mesh((n_parties,), ("pod",), [device] * n_parties)


def init_example(cfg, mesh: Mesh, seed: int = 0, batch: int = BATCH,
                 d_feat: int = D_FEAT, seq: int = SEQ) -> Dict[str, Any]:
    """Random fronts (one (d_feat, seq * d_model) matrix a silo, normal x
    0.02, on its pod device), the backbone (``init_tree``) on the
    master's device, features (one (batch, d_feat) a silo) and labels
    (batch, seq), all drawn from ``seed`` on the devices they live on."""
    devs = pod_devices(mesh)
    home = devs[0]
    g = torch.Generator(home).manual_seed(seed)
    backbone = PRM.init_tree(T.model_spec(cfg), g, torch.float32, home)
    fronts, x = [], []
    for p, dev in enumerate(devs):
        gp = torch.Generator(dev).manual_seed(seed + 1 + p)
        fronts.append(torch.randn((d_feat, seq * cfg.d_model), generator=gp,
                                  device=dev) * 0.02)
        x.append(torch.randn((batch, d_feat), generator=gp, device=dev))
    labels = torch.randint(0, cfg.vocab, (batch, seq), generator=g,
                           device=home)
    return {"fronts": fronts, "backbone": backbone, "x": x,
            "labels": labels}


def vfl_llm_loss(cfg, mesh: Mesh, fronts: Sequence[torch.Tensor], backbone,
                 x: Sequence[torch.Tensor], labels: torch.Tensor, key: int,
                 use_masks: bool = True) -> torch.Tensor:
    """The joint loss: each silo's masked soft tokens (batch, seq,
    d_model) on its device, their sum on the master's, the backbone's
    token cross-entropy on it plus the load-balance loss."""
    devs = pod_devices(mesh)
    n = len(devs)
    b, seq = labels.shape
    embs = []
    for p, dev in enumerate(devs):
        emb = (x[p].to(dev) @ fronts[p]).reshape(b, seq, cfg.d_model)
        if use_masks:
            emb = emb + secure_agg.pairwise_mask(key, p, n, emb.shape,
                                                 emb.dtype, dev)
        embs.append(emb)
    agg = psum(embs, devs[0])
    positions = torch.arange(seq, device=agg.device)
    h, aux = T._stack_forward(cfg, backbone, agg, positions)
    h = T._norm(cfg, backbone["final_norm"], h)
    logits = h @ backbone["lm_head"]["w"]
    loss, _ = layers.softmax_xent(logits, labels)
    return loss + LOAD_BALANCE_WEIGHT * aux["load_balance"]


def vfl_llm_grads(cfg, mesh: Mesh, fronts, backbone, x, labels, key: int,
                  use_masks: bool = True
                  ) -> Tuple[torch.Tensor, List[torch.Tensor], Any]:
    """(loss, the fronts' gradients, the backbone's gradient tree; None
    at a leaf the loss does not reach)."""
    f_live = [f.detach().requires_grad_() for f in fronts]
    leaf = {id(t): t.detach().requires_grad_()
            for t in PRM.tree_leaves(backbone)}
    live = PRM.tree_map(lambda t: leaf[id(t)], backbone)
    wrt = f_live + [leaf[id(t)] for t in PRM.tree_leaves(backbone)]
    with torch.enable_grad():
        loss = vfl_llm_loss(cfg, mesh, f_live, live, x, labels, key,
                            use_masks)
        got = torch.autograd.grad(loss, wrt, allow_unused=True)
    by_leaf = dict(zip(map(id, wrt[len(fronts):]), got[len(fronts):]))
    g_backbone = PRM.tree_map(lambda t: by_leaf[id(leaf[id(t)])], backbone)
    return loss.detach(), list(got[:len(fronts)]), g_backbone


def make_vfl_llm_step(cfg, mesh: Mesh, lr: float = LR,
                      use_masks: bool = True):
    """A step ``(fronts, backbone, x, labels, key) -> loss``: the
    gradients of :func:`vfl_llm_loss`, then ``p - lr * g`` written into
    every front and backbone param (a full-width backbone and its
    gradients fill most of a card; a third copy would not fit)."""
    def step(fronts, backbone, x, labels, key: int) -> torch.Tensor:
        loss, g_f, g_b = vfl_llm_grads(cfg, mesh, fronts, backbone, x,
                                       labels, key, use_masks)
        with torch.no_grad():
            for p, g in zip(fronts, g_f):
                p.sub_(lr * g)
            PRM.tree_map(lambda p, g: None if g is None
                         else p.sub_(lr * g), backbone, g_b)
        return loss
    return step


def main(argv=None) -> List[float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config("granite-moe-3b-a800m").reduced()
    mesh = silo_mesh(PRM.resolve_device(args.device))
    ex = init_example(cfg, mesh, args.seed)
    step = make_vfl_llm_step(cfg, mesh)
    losses = []
    for i in range(args.steps):
        loss = step(ex["fronts"], ex["backbone"], ex["x"], ex["labels"],
                    secure_agg.fold_in(args.seed, 100 + i))
        losses.append(float(loss))
        print(f"step {i}: loss {losses[-1]:.4f}")
    print(f"VFL-LLM (granite-moe backbone, {N_PARTIES} silo pods) "
          f"trained OK")
    return losses


if __name__ == "__main__":
    main()
