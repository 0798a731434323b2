"""Port parity: AdamW and Adafactor on deepseek-v3-671b's smoke tree (a
dense unit, a segment of 3 MoE units with stacked (E, d, F) experts and
stacked vectors, the MTP head unstacked) against repro's:
``tests/test_torch_optim.py``'s model-tree check, in a file of its own so
that the reference's jitted updates split over two test workers."""
import pytest

from test_torch_optim import _check_optimizer, _model_tree
from test_torch_optim import _one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def model_tree():
    return _model_tree("deepseek-v3-671b")


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_reference_on_model_tree(model_tree, name):
    _check_optimizer(model_tree, name)
