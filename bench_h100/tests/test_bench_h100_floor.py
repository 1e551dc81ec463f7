"""The byte floor, counted from what a CG iteration needs."""
import pytest

from bench_h100 import catalog, floor

H100 = "NVIDIA H100 80GB HBM3"


# A stored operator: 27 planes, entrywise symmetric, at 160³.
D27 = {"rows": 160 ** 3, "taps": 27, "coefficients": "planes", "planes": 27,
       "symmetric": True}


def test_floor_values():
    p7 = catalog.config("poisson7_224")
    d27 = D27
    assert floor.coefficient_planes(p7) == 0
    assert floor.coefficient_planes(d27) == 14   # 13 ± pairs and the diagonal
    assert floor.iteration_bytes(224 ** 3, 1, 0) == 6 * 44_957_696
    assert floor.iteration_floor_s(p7, 1, H100) * 1e6 == pytest.approx(80.5, abs=0.05)
    assert floor.iteration_floor_s(p7, 4, H100) * 1e6 == pytest.approx(322.08, abs=0.005)
    assert floor.iteration_floor_s(d27, 1, H100) * 1e6 == pytest.approx(97.8, abs=0.05)
    assert floor.iteration_floor_s(d27, 4, H100) * 1e6 == pytest.approx(185.85, abs=0.005)


def test_bytes_bound_not_operations():
    n = D27["rows"]
    assert (floor.iteration_flops(n, 4, 27) / 67e12
            < floor.iteration_bytes(n, 4, 14) / 3.35e12)


def test_unknown_card_has_no_floor():
    assert floor.peak(H100)["hbm_bytes_per_s"] == 3.35e12
    assert floor.iteration_floor_s(catalog.config("poisson7_224"), 1,
                                   "cpu") is None
