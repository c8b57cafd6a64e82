"""The small dragon frame at the recipe's 10 bounces, the port vs JAX op
by op (``test_torch_dragon.check_small_dragon_forest_frame``).

It is a file of its own so that ``--dist loadfile`` runs it on another
worker than the 3-bounce frame of ``test_torch_dragon.py``: the two are
the suite's longest tests.
"""

import pytest

from test_torch_dragon import _one_torch_thread  # noqa: F401  (an autouse fixture)
from test_torch_dragon import check_small_dragon_forest_frame
from test_torch_render import op_by_op  # noqa: F401  (a fixture)


@pytest.mark.parametrize("depth", [10])
def test_small_dragon_forest_frame_matches_jax(op_by_op, depth):
    """``check_small_dragon_forest_frame`` at 10 bounces."""
    check_small_dragon_forest_frame(depth)
