"""The wavefront integrator against the reference's on the features,
without NEE: Russian roulette, bump, SSS, the checker, the mesh with
glass, checker and motion, and image textures; 32x32 depth 4, 2
samples, the bounds of ``tests/torch_wavefront_ref.py``, and
``compaction="sort"`` bit-equal to ``"mask"``."""

import pytest

import torch_wavefront_ref as W

NAMES = ["cornell-rr", "bump", "sss", "cornell_checker",
         "mesh_glass_checker_motion", "cornell_tex"]


@pytest.mark.parametrize("name", NAMES)
def test_wavefront_matches_reference_wavefront(name):
    W.check(name, "reference")


@pytest.mark.parametrize("name", NAMES)
def test_wavefront_matches_reference_oracle(name):
    W.check(name, "oracle")


@pytest.mark.parametrize("name", NAMES)
def test_wavefront_within_tie_bound_of_trace_plain(name):
    W.check(name, "plain")


@pytest.mark.parametrize("name", NAMES)
def test_sort_is_mask_bit_for_bit(name):
    W.check_sort(name)
