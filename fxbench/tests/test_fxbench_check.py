"""The comparison that decides `correct`: the reference agrees with the
port on the CPU at a small size, and a run whose timed path is broken
underneath reads `correct` false, once for each fault a frame can have.
The precision control's test needs the card."""
import pytest
import torch

from helpers import SMALL, cpu_run


@pytest.mark.parametrize("workload", ["atrium_4k.hold", "atrium_4k.orbit",
                                      "atrium_4k.readback"])
def test_reference_agrees_with_the_port(workload):
    rc, res, err = cpu_run(workload, seconds=1.0)
    assert rc == 0, err
    assert res["correct"], res["checks"]
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]


def _state_unchanged(prog):
    submit = prog.submit

    def broken(info, state):
        return submit(info, state)._replace(state=state)
    prog.submit = broken


def _half_frame_left_out(prog):
    submit = prog.submit

    def broken(info, state):
        out = submit(info, state)
        color = out.color.clone()
        color[color.shape[0] // 2:] = 0.0
        return out._replace(color=color)
    prog.submit = broken


def _pixel_altered(prog):
    submit = prog.submit

    def broken(info, state):
        out = submit(info, state)
        color = out.color.clone()
        color[7, 11] = 1.0 - color[7, 11]
        return out._replace(color=color)
    prog.submit = broken


def _history_altered(prog):
    submit = prog.submit

    def broken(info, state):
        out = submit(info, state)
        st = out.state
        if st.ssao is not None:
            st = st._replace(ssao=st.ssao._replace(
                history=st.ssao.history * 0.9))
        return out._replace(state=st)
    prog.submit = broken


@pytest.mark.parametrize("fault", [_state_unchanged, _half_frame_left_out,
                                   _pixel_altered, _history_altered])
def test_a_broken_timed_path_is_not_correct(fault):
    rc, res, err = cpu_run("atrium_4k.hold", seconds=1.0, hooks=fault)
    assert rc == 0, err
    assert res["correct"] is False, res["checks"]


def _into(old, new):
    """`new` written into the tensors of `old` wherever the two match."""
    if torch.is_tensor(old) and torch.is_tensor(new) and \
            old.shape == new.shape and old.dtype == new.dtype:
        return old.copy_(new)
    if isinstance(old, tuple) and type(old) is type(new):
        return type(new)(*(_into(o, n) for o, n in zip(old, new)))
    return new


def _history_in_place(prog):
    """A sound change: from frame 1 on, each frame writes the state it
    hands on into the tensors of the state it took in."""
    submit = prog.submit

    def in_place(info, state):
        out = submit(info, state)
        if state.frame_index == 0:
            return out
        return out._replace(state=_into(state, out.state))
    prog.submit = in_place


def test_a_state_kept_in_place_is_still_correct():
    rc, res, err = cpu_run("atrium_4k.hold", seconds=1.0,
                           hooks=_history_in_place)
    assert rc == 0, err
    assert res["correct"], res["checks"]


@pytest.mark.cuda
def test_the_precision_control_is_not_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from fxbench import control, run
    from fxbench.reference.compare import judge
    for wl in ("atrium_4k.hold", "atrium_4k.orbit"):
        _, cfg, mix, _, _ = run.load_cell(wl)
        cfg = dict(cfg, **SMALL)
        for seed in (1, 2, 3):
            numbers, _ = control.control_readings(
                cfg, mix, run.scene_entries(cfg, seed), 4, "cuda")
            assert not judge(numbers, cfg["limits"]), (wl, seed, numbers)
