"""``cggp_tpu_torch.tracing``: off by default at no cost, on under
``torch.profiler`` or a ``recording()`` block; spans at the layer
boundaries, the host-read counter and the solves' statistics, on small
dense and matrix-free models on the CPU."""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cggp_tpu_torch.ops.cg as cg_module
import cggp_tpu_torch.ops.cg_implicit as cg_implicit
from cggp_tpu_torch import tracing
from cggp_tpu_torch.models.cggp import CGGP
from cggp_tpu_torch.models.implicit import ImplicitCGGP
from cggp_tpu_torch.ops import kernels
from cggp_tpu_torch.ops.cg import ConjugateGradient
from cggp_tpu_torch.training import (adam, make_adam_multi_step, make_adam_step,
                                     predict_in_batches, train_using_adam_and_update)

torch.set_num_threads(1)

N, M, B, P = 200, 16, 32, 3


def _data():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(-2, 2, (N, 2)))
    y = torch.sin(1.5 * x[:, :1]) + 0.1 * torch.as_tensor(rng.standard_normal((N, 1)))
    return x, y


X, Y = _data()


def _model(kind: str):
    """A dense ``"xla"`` CGGP or a matrix-free plain-route one (two panels
    of 8), with its float64 parameters."""
    if kind == "dense":
        model = CGGP(kernel=kernels.Matern32(), num_data=N, num_probes=P,
                     conjugate_gradient=ConjugateGradient(1e-10, matvec_impl="xla"))
    else:
        model = ImplicitCGGP(kernel=kernels.Matern32(), num_data=N, num_probes=P, block=8,
                             use_pallas=False, precondition="pivchol", precond_rank=4,
                             relative_threshold=True, error_threshold=1e-8,
                             max_cg_iterations=100)
    params = model.init_params(X[:M], pseudo_u=Y[:M], cluster_counts=torch.ones(M, 1),
                               noise_variance=0.5, dtype=torch.float64, device="cpu")
    return model, params


def _step(kind: str):
    """One Adam step of ``kind``'s model on the first batch."""
    model, params = _model(kind)
    optimizer = adam(0.01)
    step = make_adam_step(model.training_loss, optimizer, model.trainable_mask(params))
    return step(params, optimizer.init(params), (X[:B], Y[:B]),
                torch.Generator().manual_seed(3))


def _predict():
    model, params = _model("dense")
    return predict_in_batches(model, params, X[:50], batch_size=20, posterior_solver="cg")


RUNS = {"dense step": lambda: _step("dense"), "matrix-free step": lambda: _step("implicit"),
        "predict_in_batches": _predict}


def _raise(*args, **kwargs):
    raise AssertionError("called while tracing is off")


@pytest.mark.parametrize("run", RUNS)
def test_off_makes_no_range_event_or_record(run, monkeypatch):
    before = tracing.latest()
    spans_before = None if before is None else len(before.spans)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", _raise)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", _raise)
    monkeypatch.setattr(torch.cuda, "Event", _raise)
    RUNS[run]()
    assert not tracing.ON
    assert tracing.latest() is before
    assert (None if before is None else len(before.spans)) == spans_before


def _trace_events(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


@pytest.mark.parametrize("kind", ["dense", "implicit"])
def test_every_host_read_is_counted(kind, tmp_path):
    """The counter equals the profiler's ``aten::_local_scalar_dense``
    events inside the step's span."""
    with profile(activities=[ProfilerActivity.CPU]) as prof, tracing.recording() as rec:
        _step(kind)
    summary = rec.summary()
    events = _trace_events(prof, tmp_path)
    (step,) = [e for e in events if e.get("name") == "cggp.train.step"
               and e.get("cat") == "user_annotation"]
    start, end = float(step["ts"]), float(step["ts"]) + float(step["dur"])
    reads = [e for e in events if e.get("name") == "aten::_local_scalar_dense"
             and start <= float(e["ts"]) <= end]
    assert summary["calls"] == 1
    assert summary["host_reads_total"] == len(reads) > 0
    sites = {"ops.cg.cg_loop"}
    if kind == "implicit":
        sites.add("ops.cg.SpectralPreconditioner.__init__")  # eigh's info flag
    assert set(summary["host_reads"]) == sites


@pytest.mark.parametrize("kind", ["dense", "implicit"])
def test_solves_match_a_wrapper_of_the_entry(kind, monkeypatch):
    """The recorder's ``(rows, m, steps)`` list is the one a wrapper of the
    CG entry collects, backward solves included, each inside the step."""
    wrapped = []
    if kind == "dense":
        impl = cg_module._cg_dense_impl

        def wrapper(*args):
            solution, stats = impl(*args)
            wrapped.append((int(args[8].shape[-2]), int(args[7].shape[-1]), int(stats.steps)))
            return solution, stats

        monkeypatch.setattr(cg_module, "_cg_dense_impl", wrapper)
    else:
        impl = cg_implicit._implicit_cg_impl

        def wrapper(matvec, precond_state, rhs, *args):
            solution, stats = impl(matvec, precond_state, rhs, *args)
            wrapped.append((int(rhs.shape[-2]), int(rhs.shape[-1]), int(stats.steps)))
            return solution, stats

        monkeypatch.setattr(cg_implicit, "_implicit_cg_impl", wrapper)
    with tracing.recording() as rec:
        _step(kind)
    assert not tracing.ON
    summary = rec.summary()
    assert summary["solves"] == wrapped and len(wrapped) == 2
    solves = [s for s in rec.spans if s.name == tracing.SOLVE]
    assert [s.attrs["pass"] for s in solves] == ["fwd", "bwd"]
    assert all("cggp.train.step" in [a.name for a in s.ancestors()] for s in solves)
    assert all(s.call == solves[0].call for s in rec.spans)
    if kind == "implicit":
        assert summary["spans"]["cggp.cg.vjp"]["count"] == 1
        assert summary["spans"]["cggp.precond.build"]["count"] == 1
    # No CUDA event on the CPU: no device time is made up.
    assert all(entry["device_ms"] is None for entry in summary["spans"].values())


def test_self_time_is_duration_less_child_spans():
    """Self time subtracts the union of the children, those opened by a
    thread with no open span of its own included (its parent is the
    call's innermost span)."""
    with tracing.recording() as rec:
        with tracing.span("outer"):
            time.sleep(0.01)
            with tracing.span("child"):
                time.sleep(0.01)
                with tracing.span("grandchild"):
                    time.sleep(0.01)
            with tracing.span("child"):
                worker = threading.Thread(target=lambda: _sleep_in("worker", 0.01))
                worker.start()
                worker.join(timeout=10)
                assert not worker.is_alive()
    spans = {s.name: s for s in rec.spans}
    assert spans["worker"].parent.name == "child"
    assert spans["worker"].call == spans["outer"].call
    own = rec.self_seconds()
    summary = rec.summary()["spans"]
    for span in rec.spans:
        kids = [c for c in rec.spans if c.parent is span]
        covered = sum(c.end - c.start for c in kids)  # these children do not overlap
        assert own[id(span)] == pytest.approx(span.end - span.start - covered, abs=1e-9)
    outer = spans["outer"]
    assert summary["outer"]["self_s"] == pytest.approx(own[id(outer)])
    assert summary["child"]["count"] == 2
    assert 0.0 <= summary["child"]["self_s"] < summary["child"]["host_s"]


def _sleep_in(name, seconds):
    with tracing.span(name):
        time.sleep(seconds)


def test_spans_and_reads_from_many_threads_are_all_recorded():
    """More threads than cores open spans and count reads inside one call
    at a short switch interval: no span or read is lost, a thread's first
    span takes the call's innermost as its parent, and tracing ends off."""
    workers, rounds = len(os.sched_getaffinity(0)) + 2, 200
    flag = torch.tensor(True)

    def work():
        for _ in range(rounds):
            with tracing.span("thread"):
                with tracing.span("inner"):
                    assert tracing.host_read(flag)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.recording() as rec, tracing.span("outer"):
            threads = [threading.Thread(target=work) for _ in range(workers)]
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join(timeout=60)
            assert not any(thread.is_alive() for thread in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not tracing.ON
    counts = rec.summary()["spans"]
    assert counts["thread"]["count"] == counts["inner"]["count"] == workers * rounds
    assert sum(rec.host_reads.values()) == workers * rounds
    (outer,) = [s for s in rec.spans if s.name == "outer"]
    assert all(s.parent is outer for s in rec.spans if s.name == "thread")
    assert all(s.parent.name == "thread" for s in rec.spans if s.name == "inner")


@pytest.mark.parametrize("cast, value", [(bool, torch.tensor(True)), (int, torch.tensor(7)),
                                         (float, torch.tensor(2.5, dtype=torch.float64)),
                                         (torch.Tensor.cpu, torch.arange(3))])
def test_host_read_returns_what_the_bare_read_returns(cast, value):
    bare = cast(value)
    off = tracing.host_read(value, cast)
    with tracing.recording() as rec:
        on = tracing.host_read(value, cast)
    for read in (off, on):
        assert type(read) is type(bare)
        assert torch.equal(torch.as_tensor(read), torch.as_tensor(bare))
    site = f"{__name__}.test_host_read_returns_what_the_bare_read_returns"
    assert rec.host_reads == {site: 1}


def test_serving_spans_and_recordings():
    """A ``predict_in_batches`` call: its batches' spans and one solve
    each; a traced call after an untraced one starts a new recording."""
    _predict()  # untraced
    with profile(activities=[ProfilerActivity.CPU]):
        _predict()
        _predict()
    first = tracing.latest()
    summary = first.summary()
    assert summary["calls"] == 2
    # The cache (its u solve) is built inside each call, then 3 batches of 20 rows.
    assert summary["spans"]["cggp.serve.batch"]["count"] == 6
    assert summary["spans"]["cggp.serve.cache"]["count"] == 2
    assert [r for r, _m, _s in summary["solves"]] == [1, 20, 20, 20] * 2
    _predict()  # untraced
    with profile(activities=[ProfilerActivity.CPU]):
        _predict()
    assert tracing.latest() is not first and tracing.latest().calls == 1


def test_profile_dir_trace_holds_the_spans(tmp_path):
    """The spans land in ``train_using_adam_and_update``'s profiler window
    as ``user_annotation`` events."""
    model, params = _model("dense")
    train_using_adam_and_update(params, model.training_loss, (X, Y), 4, B, 0.01,
                                torch.Generator().manual_seed(0), steps_per_call=2,
                                trainable_mask=model.trainable_mask(params),
                                profile_dir=str(tmp_path / "trace"), profile_steps=(1, 2))
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"cggp.train.chunk", "cggp.train.step", "cggp.objective.loss",
            "cggp.objective.grad", "cggp.train.update", "cggp.cg.solve"} <= names
    assert not tracing.ON


def test_a_chunk_is_one_call_of_its_steps():
    model, params = _model("dense")
    optimizer = adam(0.01)
    multi_step = make_adam_multi_step(model.training_loss, optimizer, (X, Y),
                                      model.trainable_mask(params))
    idx = torch.arange(2 * B).reshape(2, B)
    with tracing.recording() as rec:
        multi_step(params, optimizer.init(params), idx, torch.Generator().manual_seed(1))
    summary = rec.summary()
    assert summary["calls"] == 1
    assert summary["spans"]["cggp.train.chunk"]["count"] == 1
    assert summary["spans"]["cggp.train.step"]["count"] == 2
    assert len(summary["solves"]) == 4
    chunk = next(s for s in rec.spans if s.name == "cggp.train.chunk")
    assert all(s is chunk or chunk in s.ancestors() for s in rec.spans)


@pytest.mark.parametrize("nested", [False, True])
def test_solve_path_lands_on_the_innermost_solve(nested):
    """``tracing.solve_path``: kernel B2's launch path on the innermost open
    solve span, through a child span too, counted by the summary's
    ``solve_paths``; nothing while off or outside a solve."""
    rhs = torch.zeros(3, 4)
    tracing.solve_path("tiled")  # off
    with tracing.recording() as rec:
        tracing.solve_path("tiled")  # no solve open
        with tracing.solve_span(rhs, 4, "pallas_resident") as span:
            span.attrs["steps"] = torch.tensor(2)
            if nested:
                with tracing.span("inner"):
                    tracing.solve_path("tiled")
            else:
                tracing.solve_path("tiled")
        with tracing.solve_span(rhs, 4, "pallas_resident") as span:
            span.attrs["steps"] = torch.tensor(1)
            tracing.solve_path("small_resident")
        with tracing.solve_span(rhs, 4, "xla") as span:
            span.attrs["steps"] = torch.tensor(1)
    summary = rec.summary()
    assert summary["solve_paths"] == {"tiled": 1, "small_resident": 1}
    assert [s.attrs.get("path") for s in rec.spans if s.name == tracing.SOLVE] == [
        "tiled", "small_resident", None]
    assert summary["solves"] == [(3, 4, 2), (3, 4, 1), (3, 4, 1)]
