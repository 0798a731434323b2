"""Port parity: ``Model.loss`` and its gradients against repro's on the
smoke configs of the MoE (deepseek-moe-16b), MLA + MoE + MTP
(deepseek-v3-671b), RWKV (rwkv6-3b), Griffin (recurrentgemma-2b) and
encoder-decoder (whisper-medium) stacks: ``tests/test_torch_loss.py``'s
check (a), the loss and each metric within 1e-4 and every gradient leaf
within 1e-4 * max(1, max |g_ref|) of ``jax.value_and_grad``'s, in a file
of its own so that the reference's jitted gradients split over two
test workers."""
import pytest

from test_torch_loss import _check_against, _reference
from test_torch_loss import _one_thread  # noqa: F401 (autouse)

STACKS = ["deepseek-moe-16b", "deepseek-v3-671b", "rwkv6-3b",
          "recurrentgemma-2b", "whisper-medium"]


@pytest.fixture(scope="module", params=STACKS)
def ref(request):
    return _reference(request.param)


def test_loss_and_grads_match_reference(ref):
    _check_against(ref)
