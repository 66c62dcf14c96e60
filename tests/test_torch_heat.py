"""The port's heat ledger (the migration policy's EWMA) against the JAX
package's ``HeatLedger`` on the same scripted ticks: the same values,
bit for bit, the same key order, and the same LRU evictions."""
import random

import pytest

from fluidframework_tpu.obs.heat import HeatLedger as RefLedger
from fluidframework_tpu_torch.obs import HeatLedger


def _script(ledger, seed, ticks=60, keys=40):
    rng = random.Random(seed)
    for _ in range(ticks):
        live = rng.sample(range(keys), rng.randrange(1, 12))
        depths = {k: rng.randrange(0, 9) for k in live
                  if rng.random() < 0.7}
        ledger.ewma_tick(live, depths, decay=rng.choice((0.5, 0.8, None)))
        if rng.random() < 0.2:
            ledger.pop(rng.randrange(keys))
    return ledger


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_ewma_ticks_match_reference_bit_for_bit(seed):
    want = _script(RefLedger(max_keys=1 << 16, decay=0.5), seed)
    got = _script(HeatLedger(max_keys=1 << 16, decay=0.5), seed)
    assert got.keys() == want.keys()
    assert [got.get(k) for k in got.keys()] == \
        [want.get(k) for k in want.keys()]
    assert got.get("absent", 7.0) == want.get("absent", 7.0) == 7.0


def test_ledger_is_deterministic_x2():
    a, b = _script(HeatLedger(), 9), _script(HeatLedger(), 9)
    assert a.keys() == b.keys()
    assert [a.get(k) for k in a.keys()] == [b.get(k) for k in b.keys()]


def test_lru_cap_evicts_least_recently_written():
    want, got = RefLedger(max_keys=4), HeatLedger(max_keys=4)
    for ledger in (want, got):
        ledger.ewma_tick([0, 1, 2, 3], {k: 1 for k in range(4)})
        ledger.ewma_tick([0], {0: 1})        # 0 becomes most recent
        ledger.ewma_tick([10], {10: 1})      # evicts 1
        ledger.ewma_tick([11], {11: 1})      # evicts 2
    assert got.keys() == want.keys() == [3, 0, 10, 11]
    assert got.evictions == want.evictions == 2
    assert 1 not in got and 0 in got and len(got) == 4
    with pytest.raises(ValueError, match="max_keys"):
        HeatLedger(max_keys=0)
