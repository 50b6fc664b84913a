"""Trainers, minibatch streams, the run monitor and its callbacks, and
batched serving (port of ``cggp_tpu/training``)."""

from cggp_tpu_torch.training.batching import minibatch_iterator
from cggp_tpu_torch.training.monitor import Monitor
from cggp_tpu_torch.training.optimize import (adam, bind_predict_fn, create_monitor,
                                              make_adam_multi_step, make_adam_step,
                                              make_cg_stats_callback, make_metrics_callback,
                                              make_param_callback, predict_in_batches,
                                              train_chunked_adam, train_full_batch_adam,
                                              train_using_adam_and_update,
                                              train_using_device_lbfgs,
                                              train_using_lbfgs_and_update,
                                              train_vanilla_using_lbfgs,
                                              train_vanilla_using_lbfgs_and_standard_ip_update)

__all__ = [
    "minibatch_iterator",
    "Monitor",
    "adam",
    "bind_predict_fn",
    "create_monitor",
    "make_adam_multi_step",
    "make_adam_step",
    "make_cg_stats_callback",
    "make_metrics_callback",
    "make_param_callback",
    "predict_in_batches",
    "train_chunked_adam",
    "train_full_batch_adam",
    "train_using_adam_and_update",
    "train_using_device_lbfgs",
    "train_using_lbfgs_and_update",
    "train_vanilla_using_lbfgs",
    "train_vanilla_using_lbfgs_and_standard_ip_update",
]
