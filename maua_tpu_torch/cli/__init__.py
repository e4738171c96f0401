"""Lazy-import helper for CLI subcommands (port of `maua_tpu/cli/__init__.py`)."""


def lazy(module_path: str, fn_name: str = "main"):
    """A function that imports `module_path` at its call and runs its `fn_name` with the arguments."""

    def run(args=None):
        import importlib

        mod = importlib.import_module(module_path)
        return getattr(mod, fn_name)(args)

    return run
