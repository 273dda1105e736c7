"""The tests of ``test_torch_tta.py`` on the camera case: the tiny
LiDAR+radar+camera config at narrow widths with the depth oracle on
(made once, from the unflipped points), fp32."""
import pytest

from tests.test_torch_tta import (_case, test_eval_step_with_tta_matches_jax,  # noqa: F401
                                  test_tta_forward_matches_jax)


@pytest.fixture(scope='module')
def case():
    return _case(True)
