"""The specs of ``tests/test_torch_port_layout_serve.py`` at world 4
(``"fsdp:2,tp:2"``) on their own 4-rank pool, against the JAX package on
a 4-device CPU mesh, at that file's tolerances."""

import pytest

from test_torch_port_collectives import pools  # noqa: F401 (fixture)
from test_torch_port_layout_serve import (MODES, check_decode,
                                          check_layered, serve_all)

PARS = {"fsdp:2,tp:2": 4}


@pytest.fixture(scope="module")
def served(pools):
    return serve_all(pools, PARS)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("par", list(PARS))
def test_layout_decode_matches_jax(served, par, mode):
    check_decode(served, par, mode)


@pytest.mark.parametrize("par", list(PARS))
def test_layered_int8_predict_on_a_layout_matches_jax(served, par):
    check_layered(served, par)
