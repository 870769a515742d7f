"""The comparison fails the controls and passes the program: the readings
behind each limit, at a size a test run holds (``control.py`` takes
them at the cells' own size on the card)."""
import pytest

from trimbench import control, reference, spec

#: per-worker counts have to pass int16's range for that control to
#: show, so the counted cells run at scale 20 here
SCALES = {"kron26.ac6": 20, "urand26.ac6": 20, "kron24.ac4": 18,
          "kron26.ac6.status": 12}


@pytest.mark.parametrize("workload", sorted(SCALES))
def test_program_passes_and_control_fails(workload):
    cell = spec.cell(workload)
    cfg = dict(cell.config, scale=SCALES[workload])
    got = [r for r in control.readings([workload], [31, 32], [32],
                                       device="cpu", config=cfg)
           if "who" in r]
    prog = [r for r in got if r["who"] == "program"]
    ctrl = [r for r in got if r["who"] != "program"]
    assert len(prog) == 2 and ctrl
    keys = list(reference.LIMITS)
    for r in prog:
        assert reference.passes({k: r[k] for k in keys if k in r}), r
    # the cell's own control: int16 counters where counted, else the
    # trim stopped a round early
    own = "int16_counters" if cell.mix["counters"] else "early_stop"
    for r in ctrl:
        if r["who"] == own:
            assert not reference.passes({k: r[k] for k in keys if k in r}), r


def test_int16_control_wraps():
    import torch
    pw = torch.tensor([40000, 10, 65536 + 5], dtype=torch.int64)
    wrapped = ((pw + (1 << 15)) % (1 << 16)) - (1 << 15)
    assert wrapped.tolist() == [40000 - 65536, 10, 5]
