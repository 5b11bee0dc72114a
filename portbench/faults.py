"""Faults planted in the program underneath a run, to show that the
comparison which decides ``correct`` catches them:

- ``unchanged``: a train step that leaves the parameters as they were
  (the optimizer's step does nothing);
- ``half_batch``: a train step whose loss leaves out the second half of
  the batch and takes the mean over the rest;
- ``answer``: scores altered where they are produced (``eval_step``'s
  positive logits moved by 0.01).

The exchange between chips has no fault here: no cell of this benchmark
spans chips.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

FAULTS = ("unchanged", "half_batch", "answer")


@contextmanager
def planted(name: str):
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}")
    from gnnflow_tpu_torch import train
    saved = {}

    def patch(obj, attr, new):
        saved[(obj, attr)] = getattr(obj, attr)
        setattr(obj, attr, new)

    if name == "unchanged":
        patch(torch.optim.Adam, "step", lambda self, closure=None: None)
    elif name == "half_batch":
        real = train.link_pred_loss

        def half(pos, neg, valid, *a, **kw):
            keep = torch.arange(valid.shape[0], device=valid.device) \
                < valid.shape[0] // 2
            return real(pos, neg, valid & keep, *a, **kw)

        patch(train, "link_pred_loss", half)
    else:
        real = train.Trainer.eval_step

        def altered(self, *a, **kw):
            state, loss, pos, neg = real(self, *a, **kw)
            return state, loss, pos + 0.01, neg

        patch(train.Trainer, "eval_step", altered)
    try:
        yield
    finally:
        for (obj, attr), v in saved.items():
            setattr(obj, attr, v)
