"""Train, eval and serve step factories of the LM zoo, and the training
state."""

from repro_torch.train.trainer import (TrainState, abstract_train_state,
                                       init_train_state, loss_and_grads,
                                       make_eval_step, make_serve_fns,
                                       make_train_step, state_tree)

__all__ = ["TrainState", "abstract_train_state", "init_train_state",
           "loss_and_grads", "make_eval_step", "make_serve_fns",
           "make_train_step", "state_tree"]
