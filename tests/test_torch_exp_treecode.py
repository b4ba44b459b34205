"""Port vs reference: the compact exponential core (core_func="exp") end
to end through treecode3 for vort2d, vort3d and vortgrad3d, with the
limits of test_torch_exp_core.py (which holds the DTT)."""

import pytest
import torch

from test_torch_exp_core import VORTEX, _check_exp

torch.set_num_threads(1)


@pytest.mark.parametrize("name", VORTEX)
def test_exp_core_treecode3_matches_reference(name):
    _check_exp(name, "treecode3")
