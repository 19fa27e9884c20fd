"""Train and serve steps.

``make_train_step`` builds the JAX package's canonical step in PyTorch's
idiom: microbatched loss and gradients -> optional gradient compression
(the bf16 cast, or int8 with error feedback) -> AdamW. The step updates
the state in place (the parameters, the moments, the error feedback):
at qwen2.5-3b's full width a second copy of the float32 state would not
fit one 80 GB card.

Gradients accumulate in the parameters' ``.grad`` (float32): each
microbatch's loss is scaled by 1/M before its backward, so its gradients
arrive pre-scaled and add into ``.grad`` in microbatch order. The
reference scales each microbatch's finished gradient by 1/M and adds it
to a separate accumulator; the sums are the same, and so are the bits
when M is a power of two (a power-of-two scale is exact), while for
other M the scale is rounded into the backward's intermediates instead
of the finished gradient. A second float32 gradient buffer would cost
12.4 GB at full width. With ``accum_dtype`` other than float32 the
reference's separate accumulator of that dtype is kept.

On a mesh the state's leaves are DTensors placed by the sharding rules
(``place_state``) and the batch is sharded as the rules shard ``"batch"``
(``place_batch``); the step is the same code, run under the mesh and the
rules with plain tensors taken as replicated (DTensor's implicit
replication), and its metrics come back as plain tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.parallel.dist import is_dtensor
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.compression import compress_grads, init_error_feedback

METRICS = ("loss", "ce", "aux", "z")


@dataclass
class TrainState:
    """The parameters (float32 leaves that require grad), the optimizer
    state ``{"m", "v", "step"}`` (and ``"ef"``, the int8 codec's error
    feedback) and the step, an int32 0-d tensor."""
    params: Any
    opt_state: Any
    step: torch.Tensor

    @staticmethod
    def create(params, opt_cfg: AdamWConfig,
               grad_compression: Optional[str] = None) -> "TrainState":
        opt = adamw_init(params, opt_cfg)
        if grad_compression == "int8":
            opt["ef"] = init_error_feedback(params)  # error feedback
        return TrainState(params=params, opt_state=opt,
                          step=torch.zeros_like(opt["step"]))


def _split_microbatches(batch: dict, n: int) -> list:
    """``n`` microbatches along the batch dim, each a dict of views. On a
    mesh each device splits its own rows (a microbatch is the i-th slice
    of every data shard: the same sequences in all, grouped otherwise than
    one device's consecutive slices, which DTensor would gather)."""
    from torch.distributed.tensor import DTensor
    out = [{} for _ in range(n)]
    for name, x in batch.items():
        local = x.to_local() if isinstance(x, DTensor) else x
        b = local.shape[0]
        if b % n:
            raise ValueError(f"batch {b} (a device's rows) is not a "
                             f"multiple of {n} microbatches")
        for i, part in enumerate(local.split(b // n)):
            out[i][name] = part if local is x else DTensor.from_local(
                part, x.device_mesh, x.placements, run_check=False)
    return out


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1, remat: str = "full",
                    grad_compression: Optional[str] = None,
                    accum_dtype=torch.float32,
                    dtype=torch.bfloat16) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics), the metrics
    ``loss``, ``ce``, ``aux``, ``z`` (microbatch means), ``lr`` and
    ``grad_norm`` as 0-d tensors on the state's device; the state is
    updated in place and returned with its step advanced.

    ``accum_dtype``: gradient-accumulation dtype (see the module
    docstring); ``dtype``: the compute dtype the float32 weights are cast
    to inside the forward.
    """

    def loss(params, mb):
        return M.loss_fn(params, mb, cfg, remat=remat, dtype=dtype)

    def train_step(state: TrainState, batch: dict):
        params = state.params
        leaves = [p for _, p in tree_leaves(params)]
        if any(is_dtensor(p) for p in leaves):
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                return _step(state, batch, params, leaves)
        return _step(state, batch, params, leaves)

    def _step(state, batch, params, leaves):
        for p in leaves:
            p.grad = None
        mbs = [batch] if microbatches == 1 \
            else _split_microbatches(batch, microbatches)
        inv = 1.0 / microbatches
        acc = None
        msum = None
        for mb in mbs:
            l, m = loss(params, mb)
            (l if microbatches == 1 else l * inv).backward()
            for p in leaves:
                # a leaf the loss never reaches (the audio arch's token
                # embedding): autograd leaves None where the reference's
                # gradient is zeros, which AdamW still decays
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            m = {k: _plain(m[k].detach()) for k in METRICS}
            if microbatches == 1:
                msum = m
            else:
                m0 = msum or {k: torch.zeros((), device=l.device)
                              for k in METRICS}
                msum = {k: m0[k] + m[k] * inv for k in METRICS}
            if accum_dtype != torch.float32:
                parts = [p.grad.to(accum_dtype) for p in leaves]
                acc = parts if acc is None else [a + x for a, x in
                                                 zip(acc, parts)]
                for p in leaves:
                    p.grad = None
        if acc is not None:
            for p, a in zip(leaves, acc):
                p.grad = a.to(torch.float32)
        grads = tree_map(lambda p: p.grad, params)

        ef = state.opt_state.get("ef")
        grads, new_ef = compress_grads(grads, grad_compression, ef)

        opt_in = {k: v for k, v in state.opt_state.items() if k != "ef"}
        _, new_opt, opt_metrics = adamw_update(grads, opt_in, params,
                                               opt_cfg)
        if new_ef is not None and ef is not None:
            new_opt["ef"] = new_ef
        for p in leaves:
            p.grad = None
        return TrainState(params, new_opt, state.step + 1), \
            {**msum, **{k: _plain(v) for k, v in opt_metrics.items()}}

    return train_step


def _plain(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value as a plain tensor; a plain tensor as it
    is."""
    return t.full_tensor() if is_dtensor(t) else t


def place_state(state: TrainState, cfg: ArchConfig, rules, mesh
                ) -> TrainState:
    """The state on ``mesh``: every parameter leaf and its moments (and
    error feedback) a DTensor placed by ``rules`` (``param_placements``
    of its spec), each device keeping its own slice of the leaf it holds
    whole (every device holds the same state); ``step`` stays plain."""
    from repro_torch.models import registry
    from repro_torch.models.param import tree_with_leaves
    from repro_torch.parallel.sharding import param_placements
    from torch.distributed.tensor import distribute_tensor
    specs = dict(tree_leaves(registry.param_specs(cfg)))

    def place(tree, grad: bool):
        vals = {}
        for path, t in tree_leaves(tree):
            d = distribute_tensor(t.detach(), mesh,
                                  param_placements(rules, specs[path], mesh),
                                  src_data_rank=None)
            vals[path] = d.requires_grad_() if grad else d
        return tree_with_leaves(tree, vals)

    opt = {k: (place(v, False) if isinstance(v, dict) else v)
           for k, v in state.opt_state.items()}
    return TrainState(place(state.params, True), opt, state.step)


def place_batch(batch: dict, rules, mesh, microbatches: int = 1) -> dict:
    """Each batch leaf a DTensor on ``mesh``, sharded by the rules'
    ``BATCH_AXES`` for its name (each device keeping its slice). With
    ``microbatches`` M the rows are first laid out microbatch by
    microbatch on every device, so that each device's i-th slice
    (``_split_microbatches``) holds its share of one device's i-th
    microbatch: the microbatches, and their MoE token groups, are one
    device's."""
    from repro_torch.data.specs import BATCH_AXES
    from repro_torch.parallel.sharding import act_placements
    from torch.distributed.tensor import distribute_tensor
    out = {}
    for k, v in batch.items():
        pl = act_placements(rules, BATCH_AXES[k], v.shape, mesh)
        n = 1
        for i, p in enumerate(pl):
            if p.is_shard(0):
                n *= mesh.size(i)
        B = v.shape[0] if v.dim() else 0
        if microbatches > 1 and n > 1 and B % (microbatches * n) == 0:
            per, part = B // microbatches, B // (microbatches * n)
            rows = [i * per + d * part + j for d in range(n)
                    for i in range(microbatches) for j in range(part)]
            v = v[torch.tensor(rows, device=v.device)]
        out[k] = distribute_tensor(v, mesh, pl, src_data_rank=None)
    return out


def make_serve_step(cfg: ArchConfig, *, dtype=torch.bfloat16) -> Callable:
    """Returns serve_step(params, cache, batch) -> (logits, cache); the
    cache is updated in place (``model.decode_step``)."""

    def serve_step(params, cache, batch):
        return M.decode_step(params, cache, batch, cfg, dtype=dtype)

    return serve_step


def make_prefill_step(cfg: ArchConfig, *, dtype=torch.bfloat16) -> Callable:
    """Returns prefill_step(params, batch, cache=None) -> (last_logits,
    cache) (``model.prefill_step``)."""

    def prefill_step(params, batch, cache=None):
        return M.prefill_step(params, batch, cfg, dtype=dtype, cache=cache)

    return prefill_step
