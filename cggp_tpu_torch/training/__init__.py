"""Trainers, minibatch streams, the run monitor and its callbacks, and
batched serving (port of ``cggp_tpu/training``)."""

from cggp_tpu_torch.training.batching import minibatch_iterator
from cggp_tpu_torch.training.gang import (gang_eval_rmse_nlpd, init_gang_adam,
                                          make_adam_gang_multi_step, make_gang_predict,
                                          shard_gang, stack_pytrees, train_gang_adam,
                                          unstack_pytree)
from cggp_tpu_torch.training.monitor import Monitor
from cggp_tpu_torch.training.optimize import (adam, bind_predict_fn, create_monitor,
                                              make_adam_multi_step, make_adam_step,
                                              make_cg_stats_callback, make_metrics_callback,
                                              make_param_callback, make_streaming_ingest_fn,
                                              predict_in_batches,
                                              train_chunked_adam, train_full_batch_adam,
                                              train_using_adam_and_update,
                                              train_using_device_lbfgs,
                                              train_using_lbfgs_and_update,
                                              train_vanilla_using_lbfgs,
                                              train_vanilla_using_lbfgs_and_standard_ip_update)

__all__ = [
    "minibatch_iterator",
    "gang_eval_rmse_nlpd",
    "make_gang_predict",
    "init_gang_adam",
    "make_adam_gang_multi_step",
    "shard_gang",
    "stack_pytrees",
    "train_gang_adam",
    "unstack_pytree",
    "Monitor",
    "adam",
    "bind_predict_fn",
    "create_monitor",
    "make_adam_multi_step",
    "make_adam_step",
    "make_cg_stats_callback",
    "make_metrics_callback",
    "make_param_callback",
    "make_streaming_ingest_fn",
    "predict_in_batches",
    "train_chunked_adam",
    "train_full_batch_adam",
    "train_using_adam_and_update",
    "train_using_device_lbfgs",
    "train_using_lbfgs_and_update",
    "train_vanilla_using_lbfgs",
    "train_vanilla_using_lbfgs_and_standard_ip_update",
]
