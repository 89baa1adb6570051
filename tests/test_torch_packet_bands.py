"""The port's packet engine against its fluid engine and the JAX package
on the quick 8-DC testbed (``tests/test_engines.py``'s stated bands, 300
ms at load 0.3): oblivious ecmp agrees across engines on p50 within 10%,
congestion-reactive lcmp within a factor of 2, LCMP stays below ECMP on
p50 and p99 under both engines, and each of the port's four runs lands
within the bands of the reference's run of the same spec (p50 3%, p99
10%, completions 1% of offered). About a minute on one worker.
"""
import pytest
import torch

from repro.netsim import experiment as rexp
from repro_torch.netsim import experiment as pexp

P50_BAND, P99_BAND, COMPLETED_BAND = 0.03, 0.10, 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The worlds here are small: torch's intra-op threads would only
    contend with the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_engines_parity_quick_testbed8():
    st = {}
    for pol in ("lcmp", "ecmp"):
        for eng in ("fluid", "packet"):
            kw = dict(topology="testbed8", load=0.3, policy=pol, engine=eng,
                      duration_us=300_000, seed=1)
            stats, _, _ = pexp.run_experiment(pexp.ExpSpec(**kw), device="cpu")
            ref, _, _ = rexp.run_experiment(rexp.ExpSpec(**kw))
            what = (pol, eng, stats.p50, ref.p50, stats.p99, ref.p99)
            assert stats.offered == ref.offered, what
            assert abs(stats.p50 - ref.p50) <= P50_BAND * ref.p50, what
            assert abs(stats.p99 - ref.p99) <= P99_BAND * ref.p99, what
            assert abs(stats.completed - ref.completed) \
                <= COMPLETED_BAND * ref.offered, what
            assert stats.completed / stats.offered > 0.95
            st[(pol, eng)] = stats
    f, p = st[("ecmp", "fluid")], st[("ecmp", "packet")]
    assert abs(p.p50 - f.p50) / f.p50 < 0.10, (f.p50, p.p50)
    f, p = st[("lcmp", "fluid")], st[("lcmp", "packet")]
    assert 0.5 < p.p50 / f.p50 < 2.0, (f.p50, p.p50)
    for eng in ("fluid", "packet"):
        assert st[("lcmp", eng)].p50 < st[("ecmp", eng)].p50, eng
        assert st[("lcmp", eng)].p99 < st[("ecmp", eng)].p99, eng
