"""The op library (counterpart of paddle_tpu/ops): plain functions on
torch tensors with the reference's names, arguments, defaults and result
dtypes, and the flash attention kernels (ops/flash_attention.py).

The star imports below are what the package re-exports, in the
reference's order, so that where two modules define one name (extras'
nansum and kron over math's and reduction's) the reference's winner
wins. Modules inside the package import what they need by name and
never reach the builtin-shadowing names (abs, all, any, max, min, pow,
round, sum) through a star import.
"""
from .common import cast, finfo, iinfo, rank, shape  # noqa: F401
from .creation import *  # noqa: F401,F403
from .creation import clone  # noqa: F401
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .math import abs, pow, round  # noqa: F401
from .reduction import *  # noqa: F401,F403
from .reduction import all, any, max, min, sum  # noqa: F401
from .extras import *  # noqa: F401,F403

# what `from paddle_tpu_torch.ops import *` gives: the ops themselves,
# not the modules, libraries and dtype helpers the op modules import
__all__ = sorted(
    n for n, v in list(globals().items())
    if not n.startswith("_") and callable(v)
    and getattr(v, "__module__", "").startswith(__name__ + ".")
    and (v.__module__ != __name__ + ".common"
         or n in ("cast", "shape", "rank", "iinfo", "finfo")))
