"""The data-parallel tests of ``test_torch_port_distributed.py`` for the
scan step with ``normalization="batch_pallas"``: the plain ``bn_stats``
on each rank's rows, its ``[2, C]`` sums all-reduced forward and their
gradient backward, against the JAX scan step on a 2-device mesh and the
port's one-process step, with the same bounds; and a copy without the
backward all-reduce caught."""

import pytest

from test_torch_port_distributed import (  # noqa: F401  (collected here)
    make_case,
    test_batchnorm_backward_all_reduce_is_needed,
    test_data_parallel_cnn_step_matches_jax_mesh_and_one_process,
)


@pytest.fixture(scope="module", params=["batch_pallas"])
def case(request, tmp_path_factory):
    return make_case(request.param, tmp_path_factory)
