"""Train, eval and serve step factories of the LM zoo, the training
state and its shardings."""

from repro_torch.train.trainer import (TrainState, abstract_train_state,
                                       batch_shardings, init_train_state,
                                       loss_and_grads, make_eval_step,
                                       make_serve_fns, make_train_step,
                                       serve_state_shardings,
                                       serve_state_specs, state_shardings,
                                       state_tree)

__all__ = ["TrainState", "abstract_train_state", "batch_shardings",
           "init_train_state", "loss_and_grads", "make_eval_step",
           "make_serve_fns", "make_train_step", "serve_state_shardings",
           "serve_state_specs", "state_shardings", "state_tree"]
