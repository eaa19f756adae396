"""LLMIDRec trained over two ranks of the port's CLI: the cases of
``test_torch_multiprocess_baselines.py`` (deterministic against the JAX
package's run over the composed batches, with the draws against the
port's own composed run, the checkpoint served by one process, at that
file's tolerances), in a file of its own so that the suite's workers
share the families' time. The user tower is a 2-layer Llama of width 64
(``TINY_LLAMA``) computing in float32."""

import pytest

from tests.test_torch_multiprocess_baselines import family_runs
from tests.test_torch_multiprocess_baselines import (  # noqa: F401  the cases
    test_cli_matches_the_jax_composed_run,
    test_draws_match_the_ports_composed_run,
    test_two_rank_checkpoint_serves_at_one_rank,
    test_two_ranks_hold_one_state,
)


@pytest.fixture(scope="module", params=["LLMIDRec"])
def runs(request, synth_dir, tmp_path_factory):
    family = request.param
    return family_runs(family, synth_dir, tmp_path_factory.mktemp(f"mp_{family}"))
