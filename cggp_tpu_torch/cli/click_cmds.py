"""The selection subcommands shared by the experiment drivers (port of
``cggp_tpu/cli/click_cmds.py``).

Each of ``covertree``, ``covernet``, ``kmeans``, ``kmeans2``, ``oips``,
``uniform`` and ``greedy`` builds ``(model, params, update_fn)`` from the
parent's ``common_ctx`` and leaves it as ``ip_ctx`` for the terminal
command under it (``compute-metrics``, ``train-adam``).
:func:`make_selection_groups` returns fresh nodes, so each driver attaches
its own terminal commands.  ``kmeans2`` dispatches to scipy's k-means++.
``covernet`` is the device delta-net (``selection/covernet.py``).
"""

from __future__ import annotations

from typing import Dict

from cggp_tpu_torch.cli.cli_utils import (Command, Context, DistanceChoices,
                                          create_model_and_update_fn)


def build_ip_ctx(common_ctx: Dict, clustering_type: str, clustering_kwargs: Dict,
                 distance_type: str) -> Dict:
    """The ``ip_ctx`` of one selection strategy: the model, its initial
    parameters and the update function, with the strategy's settings."""
    model, params, update_fn = create_model_and_update_fn(
        common_ctx["model_class"],
        common_ctx["dataset"].train,
        clustering_type=clustering_type,
        distance_type=distance_type,
        error_threshold=common_ctx.get("error_threshold", 1e-6),
        dtype=common_ctx.get("dtype"),
        seed=common_ctx.get("seed", 0),
        dot=common_ctx.get("dot", "standard"),
        jitter=common_ctx.get("jitter", 1e-6),
        relative_threshold=common_ctx.get("relative_threshold", False),
        model_kwargs=common_ctx.get("model_kwargs"),
        clustering_kwargs=clustering_kwargs,
        kernel_fn=common_ctx.get("kernel_fn"),
    )
    return dict(model=model, params=params, update_fn=update_fn,
                clustering_type=clustering_type, clustering_kwargs=clustering_kwargs,
                distance_type=distance_type)


def _group(name: str, kwargs_of) -> Command:
    def callback(ctx: Context, distance_type: str, **options):
        ctx.obj["ip_ctx"] = build_ip_ctx(ctx.obj["common_ctx"], name, kwargs_of(**options),
                                         distance_type)

    return Command(name, callback)


def _distance(cmd: Command) -> Command:
    return cmd.option("-d", "--distance-type", choices=DistanceChoices, default="euclidean")


def make_selection_groups() -> Dict[str, Command]:
    """Fresh covertree/covernet/kmeans/kmeans2/oips/uniform/greedy nodes."""
    covertree = _group("covertree", lambda spatial_resolution: {
        "spatial_resolution": spatial_resolution})
    covertree.option("-s", "--spatial-resolution", type=float, required=True)
    _distance(covertree)

    covernet = _group("covernet", lambda spatial_resolution, max_num_ip, lloyds: {
        "spatial_resolution": spatial_resolution, "max_points": max_num_ip, "lloyds": lloyds})
    covernet.option("-s", "--spatial-resolution", type=float, required=True)
    covernet.option("-m", "--max-num-ip", type=int, default=None,
                    help="Hard cap on M (net truncated with a warning, like every other "
                         "strategy's -m). Default: grow until the resolution's full net fits.")
    covernet.option("--lloyds", type=int, default=None,
                    help="Separation-preserving Lloyd's refinement rounds (default 1; "
                         "euclidean metric only).")
    _distance(covernet)

    groups = {"covertree": covertree, "covernet": covernet}
    for name in ("kmeans", "kmeans2", "uniform", "greedy"):
        cmd = _group(name, lambda max_num_ip: {"max_points": max_num_ip})
        cmd.option("-m", "--max-num-ip", type=int, required=True)
        groups[name] = _distance(cmd)

    oips = _group("oips", lambda rho, max_num_ip: {"rho": rho, "max_points": max_num_ip})
    oips.option("-r", "--rho", type=float, required=True)
    oips.option("-m", "--max-num-ip", type=int)
    groups["oips"] = _distance(oips)
    order = ("covertree", "covernet", "kmeans", "kmeans2", "oips", "uniform", "greedy")
    return {name: groups[name] for name in order}
