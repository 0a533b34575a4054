"""paddle.linalg as a module (counterpart of paddle_tpu/linalg.py): the
ported products and statistics of ops/linalg.py. The factorizations and
solves (cholesky, inv, det, svd, qr, eigh, solve, lstsq, lu, pinv, cond,
...) are not ported yet."""
from .ops.linalg import *  # noqa: F401,F403
from .ops.linalg import matrix_power, multi_dot, norm  # noqa: F401
