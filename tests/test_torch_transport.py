"""Port parity: the halo transport of the time-bin × distributed quadrant
(``repro_torch.distributed.transport``, ``repro_torch.sph.collectives``)
against the reference's ``repro.distributed.transport``.

* ``next_pow2``, ``BucketPolicy`` (the same fit sequences give the same
  buckets and events, on the reference's five scenarios),
  ``pack_rounds`` / ``pack_allgather`` and the round schedule equal the
  reference's exactly on seeded random ship slots.
* The host wire writes destination rows only; the on-device collective
  wire, in ``ppermute`` and in ``allgather`` mode, gives bit for bit the
  host wire's fields (float32 and int32) at 1, 3 and 4 ranks; padding
  slots leave the state untouched; padded pair entries add an exact +0.
"""

import numpy as np
import pytest
import torch

import repro.distributed.transport as RT
from repro.core import ppermute_rounds as ref_ppermute_rounds
from repro_torch.core import ppermute_rounds
from repro_torch.distributed import transport as PT
from repro_torch.sph.collectives import (CollectiveTransport,
                                         build_allgather_program,
                                         build_permute_program)
from torch_threads import one_torch_thread  # noqa: F401


def _bits(t: torch.Tensor) -> np.ndarray:
    a = t.cpu().numpy()
    return a.view(np.int32) if a.dtype == np.float32 else a


# ------------------------------------------------------------------ buckets
def test_next_pow2_equals_reference():
    for n in list(range(0, 130)) + [1023, 1024, 1025, 10 ** 6]:
        assert PT.next_pow2(n) == RT.next_pow2(n), n


BUCKET_SCENARIOS = {
    # the reference's five (tests/test_transport.py:42-124)
    "grow_immediate_shrink_lazy": (1, 3, [5, 9, 3, 3, 3]),
    "one_change_per_crossing": (1, 3, list(range(1, 200))
                                + [65] + [63, 65] * 50),
    "no_immediate_reshrink": (1, 3, [100, 20, 20, 20, 20, 20, 20]),
    "floor_oscillation": (8, 2, [64] + [1] * 56 + [100, 63, 65]
                          + [63, 65] * 30),
    "sustained_drop": (2, 2, [100] + [1] * 12),
}


@pytest.mark.parametrize("name", sorted(BUCKET_SCENARIOS))
def test_bucket_policy_equals_reference(name):
    min_bucket, patience, fits = BUCKET_SCENARIOS[name]
    ref = RT.BucketPolicy(min_bucket=min_bucket, shrink_patience=patience)
    port = PT.BucketPolicy(min_bucket=min_bucket, shrink_patience=patience)
    for i, n in enumerate(fits):
        assert port.fit("k", n) == ref.fit("k", n), (name, i, n)
        assert port.current("k") == ref.current("k")
    assert port.events == ref.events
    assert port._below == ref._below


# ------------------------------------------------------------ ship slots
def _random_slots(mod, rng, nranks, nrows):
    """Random exchange honouring the engine's row invariant: source rows
    (< nrows/2) and destination rows (≥ nrows/2) disjoint on every rank,
    each destination row written at most once."""
    slots = mod.ShipSlots()
    half = nrows // 2
    dst_used = {r: set() for r in range(nranks)}
    if nranks < 2:
        return slots
    for _ in range(rng.integers(1, 3 * nranks + 1)):
        s, d = rng.choice(nranks, 2, replace=False)
        free = [x for x in range(half, nrows) if x not in dst_used[d]]
        if not free:
            continue
        drow = int(rng.choice(free))
        dst_used[d].add(drow)
        slots.add(int(s), int(d), int(rng.integers(0, half)), drow)
    return slots


@pytest.mark.parametrize("seed", range(4))
def test_pack_tables_equal_reference(seed):
    nranks, nrows = 4, 12
    ref_slots = _random_slots(RT, np.random.default_rng(seed), nranks, nrows)
    port_slots = _random_slots(PT, np.random.default_rng(seed), nranks,
                               nrows)
    assert port_slots.edges == ref_slots.edges
    assert port_slots.total == ref_slots.total
    assert port_slots.max_edge_slots == ref_slots.max_edge_slots
    assert (port_slots.max_rank_exports(nranks)
            == ref_slots.max_rank_exports(nranks))
    assert (port_slots.max_rank_imports(nranks)
            == ref_slots.max_rank_imports(nranks))
    rounds = ppermute_rounds(list(port_slots.edges), nranks)
    assert rounds == ref_ppermute_rounds(list(ref_slots.edges), nranks)
    B = PT.next_pow2(port_slots.max_edge_slots)
    for a, b in zip(PT.pack_rounds(rounds, port_slots, nranks, B),
                    RT.pack_rounds(rounds, ref_slots, nranks, B)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    Bo = PT.next_pow2(port_slots.max_rank_exports(nranks))
    Bi = PT.next_pow2(port_slots.max_rank_imports(nranks))
    for a, b in zip(PT.pack_allgather(port_slots, nranks, Bo, Bi),
                    RT.pack_allgather(ref_slots, nranks, Bo, Bi)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_pack_rounds_rejects_unscheduled_edges():
    slots = PT.ShipSlots()
    slots.add(0, 1, 0, 3)
    with pytest.raises(ValueError, match="absent from the round"):
        PT.pack_rounds([], slots, 2, 8)


# ------------------------------------------------------------- the wires
def test_host_transport_touches_only_destination_rows():
    slots = PT.ShipSlots()
    slots.add(0, 1, src_row=2, dst_row=5)
    fields = [[torch.arange(8.0) + 10 * r for r in range(2)]]
    out = PT.HostTransport().exchange(slots, fields)
    a0, a1 = out[0][0].numpy(), out[0][1].numpy()
    np.testing.assert_array_equal(a0, np.arange(8.0))    # source untouched
    assert a1[5] == 2.0                                  # copied row
    keep = [i for i in range(8) if i != 5]
    np.testing.assert_array_equal(a1[keep], (np.arange(8.0) + 10)[keep])
    # the inputs themselves are not written
    np.testing.assert_array_equal(fields[0][1].numpy(), np.arange(8.0) + 10)


def _fields(rng, nranks, nrows):
    """Two float32 fields (one with a trailing 3) and one int32 field."""
    return [
        [torch.from_numpy(rng.normal(size=(nrows, 3)).astype(np.float32))
         for _ in range(nranks)],
        [torch.from_numpy(rng.normal(size=(nrows,)).astype(np.float32))
         for _ in range(nranks)],
        [torch.from_numpy(rng.integers(-5, 50, size=(nrows,))
                          .astype(np.int32)) for _ in range(nranks)],
    ]


@pytest.mark.parametrize("mode", ["ppermute", "allgather", "auto"])
@pytest.mark.parametrize("nranks", [1, 3, 4])
@pytest.mark.parametrize("seed", range(2))
def test_collective_equals_host_bitwise(mode, nranks, seed):
    rng = np.random.default_rng(100 * nranks + seed)
    nrows = 14
    fields = _fields(rng, nranks, nrows)
    host = PT.HostTransport()
    coll = CollectiveTransport(nranks=nranks, mode=mode)
    for step in range(3):                # several exchanges, one plan
        slots = _random_slots(PT, rng, nranks, nrows)
        coll.prepare([(s, d) for s in range(nranks) for d in range(nranks)
                      if s != d])
        want = host.exchange(slots, fields)
        got = coll.exchange(slots, fields)
        for f in range(len(fields)):
            for r in range(nranks):
                assert got[f][r].dtype == fields[f][r].dtype
                np.testing.assert_array_equal(_bits(got[f][r]),
                                              _bits(want[f][r]))
        fields = got
    st = coll.stats()
    assert st["host_bytes"] == 0 and st["exchanges"] == 3
    assert host.stats()["host_bytes"] > 0


def test_collective_auto_mode_follows_rounds():
    t = CollectiveTransport(nranks=4)
    t.prepare([(0, 1), (1, 0)])
    assert len(t.rounds) == 1 and t.mode == "ppermute"
    t.prepare([(s, d) for s in range(4) for d in range(4) if s != d] * 2)
    assert len(t.rounds) == 3 and t.mode == "ppermute"
    with pytest.raises(ValueError):
        CollectiveTransport(nranks=2, mode="ring")
    with pytest.raises(RuntimeError, match="prepare"):
        CollectiveTransport(nranks=2).exchange(PT.ShipSlots(), [[
            torch.zeros(2), torch.zeros(2)]])


@pytest.mark.parametrize("which", ["ppermute", "allgather"])
def test_padding_slots_leave_state_untouched(which):
    """A bucket far larger than the slots: every padding slot goes to the
    scratch row, so each rank's rows are the inputs' bits except the
    destination rows, which hold the sources' bits."""
    nranks, nrows, bucket = 3, 6, 16
    rng = np.random.default_rng(7)
    fields = [torch.from_numpy(rng.normal(size=(nranks, nrows, 3))
                               .astype(np.float32)),
              torch.from_numpy(rng.integers(0, 9, size=(nranks, nrows))
                               .astype(np.int32))]
    slots = PT.ShipSlots()
    slots.add(0, 2, src_row=1, dst_row=4)
    slots.add(2, 1, src_row=0, dst_row=5)
    if which == "ppermute":
        rounds = ppermute_rounds(list(slots.edges), nranks)
        tabs = PT.pack_rounds(rounds, slots, nranks, bucket)
        prog = build_permute_program(rounds, nranks, nrows, bucket, 2)
    else:
        tabs = PT.pack_allgather(slots, nranks, bucket, bucket)
        prog = build_allgather_program(nrows, bucket, bucket, 2)
    outs = prog(*[torch.from_numpy(a) for a in tabs], *fields)
    for f, out in zip(fields, outs):
        want = f.clone()
        want[2, 4] = f[0, 1]
        want[1, 5] = f[2, 0]
        np.testing.assert_array_equal(_bits(out), _bits(want))


def test_padded_pairs_contribute_exact_zero():
    """Mask-padded pair entries (the bucket slack, left out of the incoming
    table) change neither the density nor the force phase by a bit."""
    import warnings
    from repro_torch.sph import SimulationSpec, SPHConfig, build_simulation
    from repro_torch.sph.cellgrid import make_pair_list
    from repro_torch.sph.timebins import (_substep_density_phase,
                                          _substep_force_phase)
    spec = SimulationSpec(scenario="uniform",
                          scenario_params={"n_side": 4, "seed": 0},
                          physics=SPHConfig(alpha_visc=0.8),
                          integrator="timebin", dt_max=0.004)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        eng = build_simulation(spec, device="cpu").engine
    state, cfg = eng.state, eng.cfg
    ci, cj, shift = eng._ci, eng._cj, eng._shift
    n = len(ci)
    outs = []
    for extra in (0, 37):
        idxp = np.concatenate([np.arange(n), np.zeros(extra, np.int64)])
        pmask = torch.from_numpy(np.concatenate(
            [np.ones(n, np.float32), np.zeros(extra, np.float32)]))
        pairs = make_pair_list(ci[idxp], cj[idxp], shift[idxp],
                               eng.spec.ncells, nlive=n)
        active = state.cells.mask
        wake = torch.zeros(state.bins.shape[0], dtype=torch.int32)
        rho, om, pr, cs = _substep_density_phase(state, pairs, pmask,
                                                 active, cfg=cfg)
        new, _ = _substep_force_phase(
            state, pairs, pmask, active, rho, om, pr, cs, wake,
            torch.tensor(np.float32(0.004)), 0,
            torch.tensor(np.float32(0.0)), cfg=cfg)
        outs.append((rho, om, pr, cs, new))
    for a, b in zip(outs[0][:4], outs[1][:4]):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    sa, sb = outs[0][4], outs[1][4]
    for name in ("pos", "vel", "u"):
        np.testing.assert_array_equal(_bits(getattr(sa.cells, name)),
                                      _bits(getattr(sb.cells, name)))
    np.testing.assert_array_equal(_bits(sa.accel), _bits(sb.accel))
    np.testing.assert_array_equal(_bits(sa.bins), _bits(sb.bins))


# ------------------------------------------------------------- the probes
def test_probe_counts_distinct_signatures():
    probe = PT.CompileProbe()
    f = probe.register("f", lambda x, k: x * k)
    f(torch.zeros(4), 2)
    f(torch.ones(4), 3)                  # same shapes: same signature
    f(torch.zeros(8), 2)
    f(torch.zeros(4, dtype=torch.int32), 2)
    assert probe.counts() == {"f": 3} and probe.total_compiles() == 3
    cache = PT.ProgramCache(probe)
    g1 = cache.get(("x", 8), lambda: (lambda a: a + 1))
    g2 = cache.get(("x", 8), lambda: (lambda a: a - 1))
    assert g1 is g2 and cache.builds == 1
    g1(torch.zeros(3))
    assert probe.counts()["program:('x', 8)"] == 1


def test_transfer_probe_equals_reference():
    ref, port = RT.TransferProbe(), PT.TransferProbe()
    for name, nbytes, boundary in [("pos", 96, True), ("metrics", 40, True),
                                   ("vel", 12, False), ("bins", 8, False),
                                   ("vel", 4, False)]:
        ref.record(name, nbytes, boundary=boundary)
        port.record(name, nbytes, boundary=boundary)
    assert port.stats() == ref.stats()
    assert PT.DYNAMIC_STATE_FIELDS == RT.DYNAMIC_STATE_FIELDS
    assert PT.TRANSPORTS == RT.TRANSPORTS
    assert PT.RESIDENCIES == RT.RESIDENCIES


def test_make_transport():
    assert PT.make_transport("host", nranks=2).kind == "host"
    t = PT.make_transport("collective", nranks=2, mode="allgather")
    assert t.kind == "collective" and t.mode == "allgather"
    with pytest.raises(ValueError):
        PT.make_transport("mpi", nranks=2)
