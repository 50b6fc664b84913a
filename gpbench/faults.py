"""Faults planted under a run's timed path (``Run.hooks``), for the tests
that see ``correct`` come out false and for the readings of
``calibrate.py``.  The benchmark's own runs plant none."""

from __future__ import annotations


def unchanged_state(multi_step):
    """A step call that computes its losses and returns its state unchanged."""
    def step(params, state, idx_chunk, key):
        _, _, losses = multi_step(params, state, idx_chunk, key)
        return params, state, losses

    return step


def half_batch(loss_fn):
    """The loss over the first half of each batch only, the ELBO's data term
    scaled by N over the half."""
    def loss(params, batch, key):
        x, y = batch
        half = x.shape[0] // 2
        return loss_fn(params, (x[:half], y[:half]), key)

    return loss


def altered_answer(serve):
    """Every request's first mean moved by 1 where it is produced."""
    def altered(cache, xq, batch_size):
        mean, var = serve(cache, xq, batch_size)
        mean = mean.clone()
        mean[0] += 1.0
        return mean, var

    return altered


HOOKS = {"unchanged": {"step": unchanged_state}, "half_batch": {"loss": half_batch},
         "altered_answer": {"serve": altered_answer}}
