from . import functional  # noqa: F401
