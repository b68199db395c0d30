"""SQL frontend of the port: parser -> binder/planner -> streaming jobs."""

__all__ = ["Engine"]


def __getattr__(name):
    if name == "Engine":
        from risingwave_tpu_torch.sql.engine import Engine
        return Engine
    raise AttributeError(name)
