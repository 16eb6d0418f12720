"""K1's feature sections in the plain PyTorch version against the
reference's Pallas kernel run in interpret mode (``_run``), one case per
feature group, at 16x16, depth 3, 1 spp.  Bounds as in
``tests/test_torch_features.py``, whose helper runs the comparison."""

import pytest

from test_torch_features import check_against_reference


# glass + imperfect specular + DoF, with bump and with SSS; motion +
# checker; Russian roulette (NEE: test_torch_lights.py)
@pytest.mark.parametrize("config", [
    "bump", "sss", "cornell_checker", "cornell-rr"])
def test_trace_plain_matches_pallas_interpret(config):
    check_against_reference(config, (16, 16), 3, 1, interpret=True)
