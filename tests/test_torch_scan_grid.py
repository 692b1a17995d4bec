"""The slice as a whole, per series: ingest -> shard -> device grid ->
windowed range function, in the port against the JAX package, on the
same ingested containers (``tests/torch_slice_data.py``).  ``scan_grid``
must agree for every served range function on every dataset, with the
grid's compressed residents on and off, over spans inside one block and
across two, at strides 1 and 2.

Tolerances: on the CPU both stores keep f64 residents.  Selection ops
(last/min/max/count and the instant selector) are bit-equal; sums and
the rate chain agree to rtol 1e-9 (the prefix sums associate
differently).  The JAX store's decoded-plane programs run op by op
(``jax.disable_jit``): the same functions, without one XLA compile per
query shape.
"""

import jax
import pytest
import torch

from tests.torch_slice_data import (DATASETS, SELECTION, SERVED, SPANS, STEP,
                                    WINDOW, assert_close, fns, ids, stores)

# the shapes are small: one thread per test worker leaves the other
# workers of a parallel run their cores
torch.set_num_threads(1)


@pytest.mark.parametrize("span", sorted(SPANS))
@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("kind", sorted(DATASETS))
def test_scan_grid_matches_jax(kind, compress, span):
    jshard, tshard = stores(kind, compress)
    jids, tids = ids(jshard, tshard)
    steps0, nsteps, stride = SPANS[span]
    for name in SERVED:
        jf, tf = fns(name)
        with jax.disable_jit():
            want = jshard.scan_grid(jids, jf, steps0, nsteps,
                                    STEP * stride, WINDOW)
        got = tshard.scan_grid(tids, tf, steps0, nsteps, STEP * stride,
                               WINDOW)
        assert want is not None, name
        assert got is not None, name
        assert got[0] == want[0]
        assert_close(got[1], want[1], name in SELECTION, 1e-9,
                      f"{kind} compress={compress} {span} {name}")
