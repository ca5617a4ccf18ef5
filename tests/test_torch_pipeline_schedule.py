"""The port's pipeline schedule tables (``parallel/pipeline_schedule.py``,
copied from the JAX package's, pure numpy) against the JAX module's for a
grid of (stages S, chunks v, microbatches M), and the port's unit lists
(``parallel/pipeline.py``) against those tables: exact equality.
"""

import dataclasses

import numpy as np
import pytest

from pytorch_distributed_nn_tpu.parallel import pipeline_schedule as jsched
from pytorch_distributed_nn_tpu_torch.parallel import pipeline as tpipe
from pytorch_distributed_nn_tpu_torch.parallel import (
    pipeline_schedule as tsched,
)

GRID_1F1B = [(S, M) for S in (1, 2, 3, 4, 8) for M in (1, 2, 4, 7, 8, 16)]
GRID_INTERLEAVED = [(S, v, M) for S in (2, 3, 4) for v in (1, 2, 3)
                    for M in (S, 2 * S, 4 * S)]


def _same(got, want):
    a, b = dataclasses.asdict(got), dataclasses.asdict(want)
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(np.asarray(a[key]),
                                      np.asarray(b[key]), err_msg=key)


@pytest.mark.parametrize("S,M", GRID_1F1B)
def test_one_f_one_b_tables_equal_jax(S, M):
    _same(tsched.one_f_one_b(S, M), jsched.one_f_one_b(S, M))


@pytest.mark.parametrize("S,v,M", GRID_INTERLEAVED)
def test_interleaved_tables_equal_jax(S, v, M):
    _same(tsched.interleaved_1f1b(S, v, M), jsched.interleaved_1f1b(S, v, M))


@pytest.mark.parametrize("S,v,M", [(4, 2, 5), (2, 0, 2), (0, 1, 1)])
def test_interleaved_refuses_what_jax_refuses(S, v, M):
    with pytest.raises(ValueError):
        jsched.interleaved_1f1b(S, v, M)
    with pytest.raises(ValueError):
        tsched.interleaved_1f1b(S, v, M)


@pytest.mark.parametrize("S,M", [(2, 4), (4, 8), (4, 3)])
def test_1f1b_units_follow_the_tables(S, M):
    """Every tick's units are the tables' entries (the backward first);
    each (stage, microbatch) runs one forward and one backward."""
    sched = tsched.one_f_one_b(S, M)
    ticks = tpipe._ticks_1f1b(S, M)
    assert len(ticks) == sched.n_ticks == M + 2 * S - 1
    seen = set()
    for t, row in enumerate(ticks):
        for d in range(S):
            want = [(kind, d, int(table[t, d]))
                    for kind, table in (("B", sched.bwd), ("F", sched.fwd))
                    if table[t, d] != tsched.NO_OP]
            got = [(u.kind, u.k, u.m) for u in row[d]]
            assert got == want
            seen.update(got)
    assert len(seen) == 2 * S * M


@pytest.mark.parametrize("S,v,M", [(4, 2, 4), (2, 3, 4), (4, 3, 8)])
def test_interleaved_messages_arrive_where_the_inbox_slots_say(S, v, M):
    """A message sent at the end of tick t lands at t + 1 in the slot the
    tables allocate (``fin_write``/``bin_write``), and is consumed at the
    tick whose read slot names it: the port's hops are the JAX inboxes."""
    sched = tsched.interleaved_1f1b(S, v, M)
    ticks = tpipe._ticks_interleaved(S, v, M)
    sv = S * v
    pending = {}  # (kind, k, m) -> (device, slot)
    for t, row in enumerate(ticks):
        for d in range(S):
            for u in row[d]:
                if u.kind == "F" and u.k > 0:
                    dev, slot = pending.pop(("f", u.k, u.m))
                    assert dev == d and sched.fin_read[t, d] == slot
                if u.kind == "B" and u.k < sv - 1:
                    dev, slot = pending.pop(("b", u.k, u.m))
                    assert dev == d and sched.bin_read[t, d] == slot
        units = [u for d in range(S) for u in row[d]]
        for kind, k, m in tpipe.messages(units, sv):
            dst = k % S
            table = sched.fin_write if kind == "f" else sched.bin_write
            slot = int(table[t + 1, dst])
            assert slot != tsched.NO_OP
            pending[(kind, k, m)] = (dst, slot)
    assert not pending


@pytest.mark.parametrize("S,M", [(2, 1), (4, 4), (4, 8)])
def test_gpipe_runs_every_forward_before_every_backward(S, M):
    ticks = tpipe._ticks_gpipe(S, M)
    order = [(t, d, u.kind, u.m) for t, row in enumerate(ticks)
             for d in range(S) for u in row[d]]
    last_f = max(t for t, _, kind, _ in order if kind == "F")
    assert all(t > last_f for t, _, kind, _ in order if kind != "F")
    assert [m for _, d, kind, m in order if kind == "B" and d == 0] == \
        list(reversed(range(M)))
    assert sum(kind == "L" for _, _, kind, _ in order) == 1
