"""Tests of the output check: the control and planted faults of the
timed path come out not correct, a sound run correct.

    python -m pytest benchmark -q              # the CPU, small sizes
    python -m pytest benchmark -q -m card      # on the card, cells' sizes

Each drives ``harness.run_cell`` (the whole run but the look for a card)
with the cell's own limits. The control is the plain reference computed
in bfloat16, put in the program's place and judged by the same limits
(``control_correct``). On the CPU the galaxy runs at 3,000 bodies; the
dam's sound runs read above its limits at the sizes a CPU test can hold
(its start block spreads rounding into millimetres below some 20,000
particles), so its control, its sound run and its faults are held on the
card at 100,000 (``-m card``).
"""
from __future__ import annotations

import json

import pytest
import torch

from benchmark.harness import run_cell
from benchmark.test_bench_harness import small_dam, small_galaxy

CELLS = {"dam_100k.batch": lambda c: small_dam(c, 1500),
         "galaxy_1m.batch": lambda c: small_galaxy(c, 3000)}


def _span(spec):
    """The entities the check reads: the liquid, else every body."""
    return spec.liquid_slice if spec.n_liquid else slice(0, spec.n_entities)


def unchanged(block, spec):
    """A step that returns its state unchanged."""
    return lambda state: state


def half_left_out(block, spec):
    """The block advances only the first half of the entities; the rest
    keep their input values."""
    sl = _span(spec)
    mid = sl.start + (sl.stop - sl.start) // 2

    def run(state):
        out = block(state)
        b, o = state.bodies, out.bodies
        pos, vel = o.pos.clone(), o.vel.clone()
        pos[mid:sl.stop] = b.pos[mid:sl.stop]
        vel[mid:sl.stop] = b.vel[mid:sl.stop]
        return out.replace(bodies=o.replace(pos=pos, vel=vel))
    return run


def one_altered(block, spec):
    """One entity's position moved by a hundredth of the universe where
    the block produces it."""
    sl = _span(spec)

    def run(state):
        out = block(state)
        pos = out.bodies.pos.clone()
        span = float(pos[sl].max() - pos[sl].min())
        pos[sl.start, 0] += 0.01 * span
        return out.replace(bodies=out.bodies.replace(pos=pos))
    return run


def fiftieth_altered(block, spec):
    """A fiftieth of the entities, every fiftieth one, moved by a
    twentieth of their span where the block produces them."""
    sl = _span(spec)

    def run(state):
        out = block(state)
        pos = out.bodies.pos.clone()
        span = float(pos[sl].max() - pos[sl].min())
        pos[sl.start:sl.stop:50, 0] += 0.05 * span
        return out.replace(bodies=out.bodies.replace(pos=pos))
    return run


def pp_left_out(monkeypatch):
    """The galaxy's PP pass returns nothing (the mesh alone acts)."""
    import lpe_tpu_torch.systems.barnes_hut as bh
    make = bh.make_pp_correction

    def make_none(*args, **kw):
        pp = make(*args, **kw)

        def nothing(pos, mass):
            return torch.zeros_like(pos)
        for key in ("K", "subdivision", "ncells", "overflow_fraction",
                    "cells_of"):
            setattr(nothing, key, getattr(pp, key))
        return nothing
    monkeypatch.setattr(bh, "make_pp_correction", make_none)


def mesh_left_out(monkeypatch):
    """The galaxy's mesh returns nothing (the PP pass and the heavy sum
    alone act)."""
    import lpe_tpu_torch.systems.barnes_hut as bh
    monkeypatch.setattr(bh, "make_pm_gravity",
                        lambda *a, **kw: (lambda pos, m: torch.zeros_like(pos)))


def test_the_control_fails_the_galaxy():
    """The reference in bfloat16 in the program's place is judged not
    correct by the cell's own limits; the program, in the same run, is."""
    out = run_cell("galaxy_1m.batch", 2**31 + 3, 0.2, False, device="cpu",
                   conf_override=CELLS["galaxy_1m.batch"], control=True)
    assert out["result"]["correct"], out["readings"]
    assert out["control_correct"] is False, out["control"]


def test_a_sound_galaxy_run_is_correct():
    out = run_cell("galaxy_1m.batch", 2**31 + 5, 0.2, False, device="cpu",
                   conf_override=CELLS["galaxy_1m.batch"])
    assert out["result"]["correct"], out["readings"]


FAULTS = (unchanged, half_left_out, one_altered, fiftieth_altered)


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_a_broken_galaxy_step_is_not_correct(fault):
    out = run_cell("galaxy_1m.batch", 2**31 + 9, 0.2, False, device="cpu",
                   conf_override=CELLS["galaxy_1m.batch"], fault=fault)
    assert not out["result"]["correct"], out["readings"]
    metric = out["result"]["metrics"]["ticks_per_s.device_bound"]
    assert metric["value"] > 0


@pytest.mark.parametrize("part", (pp_left_out, mesh_left_out),
                         ids=lambda f: f.__name__)
def test_a_galaxy_without_a_part_of_p3m_is_not_correct(part, monkeypatch):
    """The disk's own gravity reaches the state: leaving out the PP pass or
    the mesh shows in the kick."""
    part(monkeypatch)
    out = run_cell("galaxy_1m.batch", 2**31 + 11, 0.2, False, device="cpu",
                   conf_override=CELLS["galaxy_1m.batch"])
    assert not out["result"]["correct"], out["readings"]


CARD_FAULTS = {
    "dam_100k.batch": (unchanged, half_left_out, fiftieth_altered),
    "galaxy_1m.batch": (unchanged, half_left_out, one_altered,
                        pp_left_out, mesh_left_out)}


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_cells_and_their_controls_on_the_card(card, name):
    """At the cells' own sizes: a sound run is correct, and the control in
    the same run is not."""
    out = run_cell(name, 2**31 + 13, 2.0, False, device=card, control=True)
    assert out["result"]["correct"], out["readings"]
    assert out["control_correct"] is False, out["control"]


@pytest.mark.card
@pytest.mark.parametrize("name,fault", [
    (name, f) for name, faults in CARD_FAULTS.items() for f in faults],
    ids=lambda v: getattr(v, "__name__", v))
def test_broken_cells_on_the_card(card, name, fault, monkeypatch):
    """At the cells' own sizes each planted fault that the cell can have
    comes out not correct: a fault of the block's output wraps the
    block, one of a part of the program is patched into it."""
    wrap = None
    if fault in (pp_left_out, mesh_left_out):
        fault(monkeypatch)
    else:
        wrap = fault
    out = run_cell(name, 2**31 + 17, 2.0, False, device=card, fault=wrap)
    assert not out["result"]["correct"], out["readings"]


def test_nonfinite_output_is_not_correct():
    def nan(block, spec):
        def run(state):
            out = block(state)
            pos = out.bodies.pos.clone()
            pos[_span(spec).start, 1] = float("nan")
            return out.replace(bodies=out.bodies.replace(pos=pos))
        return run
    out = run_cell("galaxy_1m.batch", 11, 0.2, False, device="cpu",
                   conf_override=CELLS["galaxy_1m.batch"], fault=nan)
    assert out["readings"]["nonfinite"] > 0
    assert not out["result"]["correct"]
    assert json.dumps(out["result"])          # the line stays printable
    assert torch.isfinite(torch.tensor(out["result"]["attempted"]))
