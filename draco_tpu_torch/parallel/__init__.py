"""The LM routes of the port (draco_tpu/parallel), each shard axis a
tensor axis on one card: the default sequence-parallel step (one shard or
``seq_shards``, with or without Switch experts, ``sp_step.py``), tensor
parallelism (``tp_step.py``), expert parallelism (``ep_step.py``) and the
GPipe pipeline (``pp_step.py``), and their token loop.

:func:`route_of` picks a configuration's route as the reference's CLI
does (tp, then ep, then pp, else sp); :func:`build_route_setup` and
:func:`train_route` build and run it.
"""


def route_of(cfg) -> str:
    """The LM route ``cfg`` runs on, in the reference's order
    (draco_tpu/cli.py): ``tensor_shards > 1``, then ``expert_shards > 1``,
    then the pipeline (``pipeline_shards > 1`` or ``pp_microbatches >
    0``), else the sp route."""
    if cfg.tensor_shards > 1:
        return "tp"
    if cfg.expert_shards > 1:
        return "ep"
    if cfg.pipeline_active:
        return "pp"
    return "sp"


def _module(route: str):
    import importlib

    return importlib.import_module(f"draco_tpu_torch.parallel.{route}_step")


def build_route_setup(cfg, device=None, route=None, **kw):
    """The step of ``cfg``'s route (or ``route``) on ``device``; ``kw`` as
    the route's builder takes it (``init=``)."""
    route = route or route_of(cfg)
    return getattr(_module(route), f"build_{route}_train_setup")(
        cfg, device, **kw)


def train_route(cfg, device=None, steps=None, quiet: bool = False):
    """``cfg``'s route's training loop; returns (state, the last step's
    record)."""
    route = route_of(cfg)
    return getattr(_module(route), f"train_{route}")(cfg, device, steps,
                                                    quiet)
