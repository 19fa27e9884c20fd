"""Step builders: training (``make_train_step``, ``TrainState``) and
serving (``make_serve_step``, ``make_prefill_step``)."""
from repro_torch.train.steps import (TrainState, make_prefill_step,
                                     make_serve_step, make_train_step)

__all__ = ["TrainState", "make_train_step", "make_serve_step",
           "make_prefill_step"]
