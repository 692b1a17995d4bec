"""Co-arrival groups in the port's device store over gappy ts-mode data
(``tests/torch_slice_data.py``'s jittered counters, missed scrapes in
half the series): groups of 2, 3 and 8 concurrent queries, per series and
under ``sum by``, for rate, increase, sum_over_time and max_over_time;
each member bit for bit its solo answer, and within rtol 1e-9 of the JAX
package's batched member (selection and counts exact).  The phase-mode
groups and the batcher's own tests are ``tests/test_torch_batching.py``.
"""

import pytest
import torch

from tests.torch_batch_data import (FUNCS, check_groups,  # noqa: F401
                                    closed_breaker_and_stores)

torch.set_num_threads(1)


@pytest.mark.parametrize("name", FUNCS)
@pytest.mark.parametrize("shape", ["series", "grouped"])
def test_store_groups_match_solo_and_jax(shape, name):
    check_groups("jitter", shape, name)
