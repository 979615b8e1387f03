"""Kernel parity on the card (chip_smoke.py phase 2 as tests).

Each compares the GPU path with the same code jitted on the CPU device of
the process, at the sensor configurations' widths. They skip where there
is no GPU; on the card run

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -q -m gpu
"""

import pytest

import chip_smoke as cs

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("hw,K,n_features,n_points", [
    (cs.HW_TUM, cs.K_TUM, 1000, 1400),
    (cs.HW_KITTI, cs.K_KITTI, 2000, 3000),
])
def test_extract_matches_cpu(gpu_device, hw, K, n_features, n_points):
    cs.parity_extract(hw, K, n_features, 8, n_points)


def test_pose_lm_kernel_matches_cpu(gpu_device):
    cs.parity_pose()


def test_local_ba_matches_cpu(gpu_device):
    cs.parity_lba()
