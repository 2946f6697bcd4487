"""The port's NFE ledger (``utils/profiling.count_nfe`` / ``record_nfe``).

- one ``count_nfe`` context against diffpure_tpu's (eager records: its
  ``jax.debug.callback`` runs at once); nested contexts: the inner ledger
  takes the records made inside it and the outer one resumes after it
  (diffpure_tpu's ``count_nfe`` uninstalls every ledger on exit instead);
- the ledger is the calling thread's: records made in another thread do
  not land in it, and a ledger that thread opens counts only its own.
"""
import threading

import pytest

from diffpure_tpu.utils.profiling import count_nfe as jax_count_nfe
from diffpure_tpu.utils.profiling import record_nfe as jax_record_nfe
from diffpure_tpu_torch.utils.profiling import count_nfe, record_nfe


def _flat(count, record):
    with count() as c:
        record("sde_euler", 3)
        record("guided_ddpm", 2)
        record("sde_euler", 5)
    record("sde_euler", 7)  # no ledger installed: dropped
    return dict(c.counts), c.total(), c.report()


def test_ledger_matches_jax():
    assert _flat(count_nfe, record_nfe) == _flat(jax_count_nfe, jax_record_nfe)


def test_nested_ledgers():
    with count_nfe() as outer:
        record_nfe("sde_euler", 3)
        with count_nfe() as inner:
            record_nfe("sde_euler", 5)
            record_nfe("guided_ddpm", 2)
        record_nfe("ode_euler", 1)
    record_nfe("sde_euler", 7)
    assert dict(outer.counts) == {"sde_euler": 3, "ode_euler": 1}
    assert dict(inner.counts) == {"sde_euler": 5, "guided_ddpm": 2}


@pytest.mark.parametrize("other_opens_ledger", [False, True])
def test_ledger_is_the_calling_threads(other_opens_ledger):
    seen = {}

    def other():
        if other_opens_ledger:
            with count_nfe() as mine:
                record_nfe("celebahq_ddpm", 4)
            seen["other"] = dict(mine.counts)
        else:
            record_nfe("celebahq_ddpm", 4)

    with count_nfe() as main:
        record_nfe("guided_ddpm", 2)
        worker = threading.Thread(target=other)
        worker.start()
        worker.join()
        record_nfe("guided_ddpm", 1)
    assert dict(main.counts) == {"guided_ddpm": 3}
    if other_opens_ledger:
        assert seen["other"] == {"celebahq_ddpm": 4}
