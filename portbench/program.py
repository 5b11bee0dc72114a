"""The system under test, ``gnnflow_tpu_torch``, built through its own API
from a configuration file and the benchmark's inputs.  This is the only
module of the harness that imports the program."""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List

import torch

# the registry keys of a model configuration (gnnflow_tpu_torch/config.py)
MODEL_KEYS = ("dropout", "att_head", "att_dropout", "num_layers", "fanouts",
              "sample_strategy", "num_snapshots", "snapshot_time_window",
              "prop_time", "use_memory", "dim_time", "dim_embed",
              "dim_memory", "batch_size")


@dataclass
class Program:
    model: object
    trainer: object
    state: object
    dgraph: object

    def view(self, device):
        return self.dgraph.device_graph(device)

    def params(self) -> Dict[str, torch.Tensor]:
        return {k: p.detach().clone()
                for k, p in self.model.named_parameters()}

    def memory(self) -> Dict[str, torch.Tensor]:
        m = self.state.memory
        return {"mem": m.node_memory.clone(), "mem_ts": m.node_memory_ts.clone(),
                "mail": m.mailbox.clone()}

    def first_grads(self) -> Dict[str, torch.Tensor]:
        """Each leaf's gradient of the first step, as Adam holds it after
        that step: its first moment over ``1 - beta1``."""
        opt = self.state.optimizer
        b1 = opt.param_groups[0]["betas"][0]
        return {k: opt.state[p].get("exp_avg", torch.zeros_like(p))
                / (1.0 - b1) for k, p in self.model.named_parameters()}

    def adam_state(self):
        opt = self.state.optimizer
        ps = dict(self.model.named_parameters())
        st = {k: opt.state[p] for k, p in ps.items()}
        get = lambda k, n: st[k][n].clone() if n in st[k] \
            else torch.zeros_like(ps[k])
        return ({k: get(k, "exp_avg") for k in ps},
                {k: get(k, "exp_avg_sq") for k in ps},
                int(next(iter(st.values())).get("step", 0)))

    def restart(self, cfg: dict, edges, weights, seeds, device) -> None:
        """The state a fresh build would have (a new store over ``edges``,
        the weights, zero memory, an empty optimizer state, the
        generators seeded again), keeping what the trainer calibrated."""
        from gnnflow_tpu_torch.dynamic_graph import build_dynamic_graph
        self.dgraph = build_dynamic_graph(**cfg["data"], dataset=edges)
        with torch.no_grad():
            for k, p in self.model.named_parameters():
                p.copy_(weights[k])
        self.model.cast_weights()
        self.reset_memory()
        self.state.optimizer.state.clear()
        self.state.step = 0
        self.state.dropout_gen.manual_seed(seeds[0])
        self.state.sample_gen.manual_seed(seeds[1])

    def reset_memory(self) -> None:
        from gnnflow_tpu_torch.models import memory as memory_lib
        if self.state.memory is not None:
            memory_lib.reset_memory(self.state.memory)


def param_shapes(cfg: dict, dim_edge: int) -> Dict[str, tuple]:
    """The parameter layout of the configuration's model (built on the
    CPU, then dropped)."""
    from gnnflow_tpu_torch.models.factory import build_model
    model, _ = build_model(cfg["model"], model_config(cfg), 0, dim_edge,
                           seed=0, device="cpu")
    return {k: tuple(p.shape) for k, p in model.named_parameters()}


def model_config(cfg: dict, compute_dtype: str = "float32") -> dict:
    out = {k: cfg[k] for k in MODEL_KEYS if k in cfg}
    if compute_dtype != "float32":
        out["compute_dtype"] = compute_dtype
    return out


def build(cfg: dict, edges, num_nodes: int, dim_edge: int, weights,
          seeds, device, compute_dtype: str = "float32",
          mark=lambda phase: None) -> Program:
    """The store over ``edges``, the model with ``weights`` and a trainer
    whose dropout and sampling generators are seeded with ``seeds``;
    ``mark(phase)`` is called after the store and after the model."""
    from gnnflow_tpu_torch.dynamic_graph import build_dynamic_graph
    from gnnflow_tpu_torch.models.factory import build_model
    from gnnflow_tpu_torch.train import Trainer
    dgraph = build_dynamic_graph(**cfg["data"], dataset=edges)
    mark("store")
    model, kw = build_model(cfg["model"], model_config(cfg, compute_dtype),
                            0, dim_edge, seed=0, device=device)
    mark("model")
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(weights[k])
    model.cast_weights()
    trainer = Trainer(model, lr=cfg["lr"], device=device, **kw)
    state = trainer.init_state(num_nodes, seed=0)
    state.dropout_gen = torch.Generator(device=device).manual_seed(seeds[0])
    state.sample_gen = torch.Generator(device=device).manual_seed(seeds[1])
    return Program(model, trainer, state, dgraph)


@contextmanager
def recorded_draws(state, log: Dict[str, List[tuple]]):
    """Record the shape of every ``torch.rand`` draw from the state's
    dropout and sampling generators (``log["dropout"]``,
    ``log["sample"]``) while the block runs; the draws are unchanged."""
    real = torch.rand
    gens = {id(state.dropout_gen): "dropout", id(state.sample_gen): "sample"}

    def rand(*size, generator=None, **kw):
        out = real(*size, generator=generator, **kw)
        if generator is not None and id(generator) in gens:
            log.setdefault(gens[id(generator)], []).append(tuple(out.shape))
        return out

    torch.rand = rand
    try:
        yield log
    finally:
        torch.rand = real


def view_edges(view) -> tuple:
    """The edges a device view of the store holds, node by node in id
    order, each node's in its slot order: ``(src, dst, ts, eid)``."""
    off, ln = view.row_off.long(), view.row_len.long()
    src = torch.repeat_interleave(torch.arange(len(ln), device=ln.device),
                                  ln)
    starts = torch.repeat_interleave(off, ln)
    first = torch.repeat_interleave(torch.cumsum(ln, 0) - ln, ln)
    idx = starts + torch.arange(int(ln.sum()), device=ln.device) - first
    return src, view.e_dst[idx].long(), view.e_ts[idx], view.e_eid[idx].long()
