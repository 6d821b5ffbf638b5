"""Split-learning VFL protocol of the PyTorch port.

Members own bottom towers over their feature slices; the master owns
the top model and labels. Per training round:

1. members send bottom activations u_p = f_p(X_p),
2. the master sums u = u_master + sum_p u_p, runs the top model and the
   multi-label BCE loss,
3. the master backprops, takes a plain SGD step on its top and bottom
   models and returns du_p to each member (the only gradient signal
   that crosses the boundary),
4. members apply their bottom VJP locally.

Predict is the forward half federated end to end: members answer
feature-slice queries with bottom activations, the master sums them
with its own bottom activation and runs the top model — nobody ever
holds another silo's features or parameters.

Models come from the port's tower factory (``repro_torch.models.tower``)
with the same specs, param layouts and checkpoint trees as the JAX
package's ``repro/core/protocols/split_nn.py``, so a JAX-written
checkpoint (``resume_dir``) serves here unchanged. Each party keeps its
matched feature rows as one tensor on its ``device`` and gathers query
rows there; tensors become numpy at every channel send and every return
to the driver.

The math is the JAX package's step for step: autograd of the same loss
over the same trees, ``p - lr * g`` in float32, and the member's VJP
recomputed at its current params when its gradient arrives.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.comm import schema
from repro_torch.comm.schema import Field
from repro_torch.core.protocols import base
from repro_torch.core.protocols.driver import VFLProtocol
from repro_torch.models import tower as twr

# the same wire declarations as the JAX package: one world may mix
# parties of both packages on the predict path
schema.message("splitnn/u", {"u": Field("float32", 2)}, stepped=True,
               compress=True,
               doc="member bottom activations for one training round")
schema.message("splitnn/du", {"du": Field("float32", 2)}, stepped=True,
               compress=True,
               doc="embedding gradient returned to one member")
schema.message("splitnn/pred_u", {"u": Field("float32", 2)}, stepped=True,
               doc="bottom activations for a predict query")


def _bce(logits, y):
    return torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-logits.abs())))


def _grads(out, tree, extra, grad_out=None):
    """d out / d (tree's tensors, then ``extra``), with the tree's
    tensors made leaves that require grad; zeros for a tensor ``out``
    does not reach, as JAX's gradients have."""
    params = [t.detach().requires_grad_() for t in twr.leaves(tree)]
    live = twr.with_leaves(tree, params)
    with torch.enable_grad():
        y = out(live)
        gs = torch.autograd.grad(y, params + list(extra), grad_out,
                                 allow_unused=True)
    gs = [torch.zeros_like(t) if g is None else g
          for t, g in zip(params + list(extra), gs)]
    return y, gs


def _sgd(tree, grads, lr: float):
    with torch.no_grad():
        return twr.with_leaves(tree, [p - lr * g for p, g in
                                      zip(twr.leaves(tree), grads)])


def master_step(bspec: twr.TowerSpec, tspec: twr.TowerSpec, top, bottom,
                u_members, x, y, lr: float):
    """The master's round, the JAX package's ``_make_master_step``:
    the BCE loss of the top model on its own bottom activations plus the
    members' ``u_members``, its gradients over the top params, the
    bottom params and each member's activations, and a plain SGD step
    ``p - lr * g`` (``lr`` a float32 value). Returns (loss, new top, new
    bottom, du per member)."""
    u_members = [u.detach().requires_grad_() for u in u_members]

    def loss_of(trees):
        u = twr.apply(bspec, trees[1], x)
        for um in u_members:
            u = u + um
        return _bce(twr.apply(tspec, trees[0], u), y)

    loss, grads = _grads(loss_of, [top, bottom], u_members)
    n_top, n_bottom = len(twr.leaves(top)), len(twr.leaves(bottom))
    return (loss.detach(), _sgd(top, grads[:n_top], lr),
            _sgd(bottom, grads[n_top:n_top + n_bottom], lr),
            grads[n_top + n_bottom:])


def member_step(spec: twr.TowerSpec, params, x, du, lr: float,
                rules=None):
    """A member's backward, the JAX package's ``_make_member_fns``
    ``bwd``: the VJP of its bottom tower at ``params`` on ``x`` against
    ``du``, and an SGD step, through the tower's ``rules`` (a sharded
    tower's parts each get their share of the gradient). Returns the new
    params."""
    _, grads = _grads(lambda trees: twr.apply(spec, trees[0], x, rules),
                      [params], [], du)
    return _sgd(params, grads, lr)


def bottom_spec(cfg, in_dim: int) -> twr.TowerSpec:
    """Resolve the bottom-model tower for one party's feature width."""
    if cfg.tower:
        return twr.resolve(tuple(cfg.tower), in_dim, cfg.embedding_dim)
    return twr.mlp_tower(in_dim, cfg.hidden, cfg.embedding_dim,
                         final_act=True)


def top_spec(cfg, items: int) -> twr.TowerSpec:
    """Resolve the master's top-model tower (embeddings -> logits)."""
    if cfg.top_tower:
        return twr.resolve(tuple(cfg.top_tower), cfg.embedding_dim,
                           items)
    return twr.mlp_tower(cfg.embedding_dim, cfg.hidden, items,
                         final_act=False)


def init_generator(seed: int, stream: int) -> torch.Generator:
    """The init stream of one model of the federation: the master's
    bottom (0) and top (1) and member ``i`` (``i + 2``), as the JAX
    package folds them into its key."""
    state = np.random.SeedSequence([seed, stream]).generate_state(1)
    return torch.Generator().manual_seed(int(state[0]))


@base.register
class SplitNNProtocol(VFLProtocol):
    name = "split_nn"
    supports_pipeline = True

    def setup(self) -> None:
        cfg, d, dev = self.cfg, self.data, self.device
        # the JAX package's float32 learning rate
        self.lr = float(np.float32(cfg.lr))
        self.x = torch.as_tensor(
            base._select(d.ids, self.order, d.x), dtype=torch.float32
        ).to(dev)
        if self.is_master:
            self.y = torch.as_tensor(
                base._select(d.ids, self.order, d.y), dtype=torch.float32
            ).to(dev)
            self._bspec = bottom_spec(cfg, self.x.shape[1])
            self._tspec = top_spec(cfg, self.y.shape[1])
            self.bottom = twr.init(self._bspec,
                                   init_generator(cfg.seed, 0), dev)
            self.top = twr.init(self._tspec, init_generator(cfg.seed, 1),
                                dev)
        else:
            midx = int(self.role.replace("member", "")) + 2
            self._spec = bottom_spec(cfg, self.x.shape[1])
            self.params = twr.init(self._spec,
                                   init_generator(cfg.seed, midx), dev)
            # model-parallel placement of a large member tower over the
            # distinct local devices of the party's type; tower_shard 1
            # (the default) never builds a mesh
            self._rules = twr.make_tower_rules(cfg.tower_shard, device=dev)
            self.params = twr.shard_tower(self.params, self._spec,
                                          self._rules)
            self.masker = None
            # mask-stream namespace for predict queries: every member
            # sees the same EVAL round sequence, so a shared counter
            # keeps pairwise masks aligned without colliding with
            # training-step masks
            self._pred_step = 1 << 20
            if cfg.secure_agg:
                if cfg.compress:
                    raise ValueError("secure_agg masks do not survive "
                                     "independent quantization; choose one")
                from repro_torch.core.secure_agg_protocol import \
                    PairwiseMasker
                self.masker = PairwiseMasker(self.ch.comm, self.role,
                                             self.ch.members)

    def _index(self, rows) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rows, np.int64),
                               device=self.device)

    def _rows(self, rows) -> torch.Tensor:
        return self.x[self._index(rows)]

    def roofline_profile(self) -> Dict[str, float]:
        """Analytic per-step cost for the roofline accounting
        (launch/roofline.py): training FLOPs ~= 3x the forward pass
        (fwd + input/weight VJPs), wire bytes = the float32 u/du
        exchange this role sees each round."""
        cfg = self.cfg
        nb = cfg.batch_size
        ubytes = nb * cfg.embedding_dim * 4
        if self.is_master:
            flops = 3.0 * (twr.tower_flops(self._bspec, nb)
                           + twr.tower_flops(self._tspec, nb))
            wire = 2 * ubytes * max(1, len(self.ch.members))
            pbytes = twr.params_bytes(self.bottom) \
                + twr.params_bytes(self.top)
        else:
            flops = 3.0 * twr.tower_flops(self._spec, nb)
            wire = 2 * ubytes
            pbytes = twr.params_bytes(self.params)
        return {"flops_per_step": flops, "bytes_per_step": float(wire),
                "params_bytes": float(pbytes)}

    # -- training ------------------------------------------------------------
    def on_batch_master(self, rows, step) -> float:
        ch = self.ch
        msgs = ch.gather(ch.members, "splitnn/u")
        # fit_rows: a stale substitution (down/straggling peer) may
        # carry a different tail-batch row count than this round
        u_members = [torch.as_tensor(base.fit_rows(m.tensor("u"), len(rows)),
                                     dtype=torch.float32).to(self.device)
                     for m in msgs]
        idx = self._index(rows)
        loss, self.top, self.bottom, du = master_step(
            self._bspec, self._tspec, self.top, self.bottom, u_members,
            self.x[idx], self.y[idx], self.lr)
        for mname, g in zip(ch.members, du):
            # isend: the per-member gradient writes overlap each other
            # and the next round's activation gather
            ch.isend(mname, "splitnn/du", {"du": g.cpu().numpy()})
        return float(loss)

    @torch.no_grad()
    def member_stage_send(self, rows, step):
        """Bottom forward + activation isend; the batch slice is the ctx
        the deferred backward stage reuses (its VJP must see the inputs
        this forward actually saw). No autograd graph is kept: at
        pipeline depth >= 2 the params move on before the gradient
        arrives, and the VJP is taken at the params of that moment, as
        the JAX package takes it."""
        xb = self._rows(rows)
        u = twr.apply(self._spec, self.params, xb,
                      self._rules).cpu().numpy()
        if self.cfg.noise_sigma > 0:
            # noising defense (docs/privacy.md): the member perturbs
            # its outgoing embedding, so neither the master nor a wire
            # adversary ever sees the clean activations
            u = u + base.defense_noise(self.cfg, u, step, self.role)
        if self.masker is not None:
            # pairwise masks on the numpy activations on the wire; they
            # cancel in the master's sum
            u = u + self.masker.mask(step, u.shape)
        self.ch.isend("master", "splitnn/u", {"u": u})
        return xb

    def member_stage_recv(self, rows, step, xb) -> None:
        du = torch.as_tensor(self.ch.recv("master", "splitnn/du").tensor("du"),
                             dtype=torch.float32).to(self.device)
        self.params = member_step(self._spec, self.params, xb, du, self.lr,
                                  self._rules)

    # -- predict/serve -------------------------------------------------------
    @torch.no_grad()
    def predict_master(self, rows) -> np.ndarray:
        u = twr.apply(self._bspec, self.bottom, self._rows(rows))
        for msg in self.ch.gather(self.ch.members, "splitnn/pred_u"):
            u = u + torch.as_tensor(msg.tensor("u"),
                                    dtype=torch.float32).to(self.device)
        return twr.apply(self._tspec, self.top, u).cpu().numpy()

    def predict_member(self, rows) -> None:
        self.send_embed(self.predict_embed(rows), rows)

    @torch.no_grad()
    def predict_embed(self, rows) -> np.ndarray:
        # pure bottom-model forward: cacheable per row (no masking —
        # masks are per-query and applied in send_embed)
        return twr.apply(self._spec, self.params, self._rows(rows),
                         self._rules).cpu().numpy()

    def send_embed(self, u, rows) -> None:
        if self.masker is not None:
            # predict queries get the same pairwise masking as training
            # rounds — the master only ever sees the aggregate
            u = np.asarray(u + self.masker.mask(self._pred_step, u.shape),
                           np.float32)
            self._pred_step += 1
        self.ch.send("master", "splitnn/pred_u", {"u": np.asarray(u)})

    def evaluate_master(self, scores, rows) -> Dict[str, float]:
        from repro_torch.train.evals import recsys_report
        return recsys_report(np.asarray(scores),
                             self.y[self._index(rows)].cpu().numpy(), k=5)

    def finalize(self) -> Dict:
        if self.is_master:
            return {"top": twr.to_numpy(self.top),
                    "bottom": twr.to_numpy(self.bottom),
                    "order": self.order}
        return {"params": twr.to_numpy(self.params)}

    def _ef_residuals(self) -> Dict:
        # error feedback lives on the typed channel (schema-level
        # compression); its residuals are part of this role's state
        ef = self.ch.error_feedback
        return dict(ef.residuals) if ef is not None else {}

    def state_dict(self) -> Dict:
        if self.is_master:
            return {"top": twr.to_numpy(self.top),
                    "bottom": twr.to_numpy(self.bottom),
                    "ef": self._ef_residuals()}
        return {"params": twr.to_numpy(self.params),
                "ef": self._ef_residuals()}

    def _as_tower(self, state):
        """Migrate pre-§12 checkpoints: a flat legacy MLP layer list
        becomes the one-block tower param tree. A legacy layer is a
        dict of exactly ``{'w', 'b'}`` — new-format block entries
        never look like that (an mlp block is a *list* of layers;
        embed/attn dicts carry extra keys), so checking the full key
        set keeps embed-first towers out of the legacy path."""
        if (state and isinstance(state[0], dict)
                and set(state[0]) == {"w", "b"}):
            state = [state]
        return twr.from_numpy(state, self.device)

    def load_state_dict(self, state) -> None:
        if self.is_master:
            self.top = self._as_tower(state["top"])
            self.bottom = self._as_tower(state["bottom"])
        else:
            self.params = twr.shard_tower(self._as_tower(state["params"]),
                                          self._spec, self._rules)
        if state.get("ef"):
            from repro_torch.core import compression
            # migrate pre-§7 checkpoints: the protocol-owned EF keyed
            # streams as "u" (member) / member name (master); channel
            # EF keys are "{to}/{msg-type}/{field}"
            residuals = {}
            for k, v in state["ef"].items():
                if "/" in k:
                    residuals[k] = v
                elif k == "u":
                    residuals["master/splitnn/u/u"] = v
                else:
                    residuals[f"{k}/splitnn/du/du"] = v
            if self.ch.error_feedback is None:
                self.ch.error_feedback = compression.ErrorFeedback()
            self.ch.error_feedback.residuals = residuals
