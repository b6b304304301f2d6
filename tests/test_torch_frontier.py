"""The async plane's pure components in both packages on the CPU: ``engine/frontier.py``
(``FrontierTracker``, ``QuiesceVotes``) and the pure half of ``observability/critpath.py``
(holder election, stage split, ``WaveRecorder``, the worker and process merges), with
``EngineStats.note_wave`` and ``note_e2e`` beside them.

Each case runs the same event sequence through the JAX package's classes and the port's, holds
each side to the values ``tests/test_frontier.py`` and ``tests/test_critpath.py`` expect, and
requires the two packages' results to be equal (exact: these are integers, booleans, strings and
the same float arithmetic in the same order).
"""

from __future__ import annotations

import time
import types

import pytest

import pathway_tpu.engine.executor as jexec
import pathway_tpu.engine.frontier as jfrontier
import pathway_tpu.observability.critpath as jcrit
import pathway_tpu_torch.engine.executor as texec
import pathway_tpu_torch.engine.frontier as tfrontier
import pathway_tpu_torch.observability.critpath as tcrit

PACKAGES = {
    "jax": types.SimpleNamespace(frontier=jfrontier, crit=jcrit, executor=jexec),
    "torch": types.SimpleNamespace(frontier=tfrontier, crit=tcrit, executor=texec),
}


# -- FrontierTracker ---------------------------------------------------------------------------


def local_advance_is_monotone(m):
    ft = m.frontier.FrontierTracker(2, 0)
    out = [ft.local()]
    ft.advance_local(10)
    ft.advance_local(10)  # equal re-advance: lawful no-op
    out.append(ft.local())
    with pytest.raises(ValueError):
        ft.advance_local(8)
    with pytest.raises(ValueError):
        m.frontier.FrontierTracker(2, 2)
    assert out == [-1, 10]
    return out


def broadcast_merge_across_workers(m):
    ft = m.frontier.FrontierTracker(3, 0)
    ft.advance_local(100)
    out = [ft.observe(1, 50), ft.observe(2, 80), ft.frontiers(), ft.global_frontier()]
    out += [ft.observe(1, 50), ft.observe(1, 40), ft.frontiers()[1]]
    out += [ft.observe(1, 120), ft.global_frontier()]
    with pytest.raises(ValueError):
        ft.observe(3, 1)
    assert out == [True, True, [100, 50, 80], 50, False, False, 50, True, 80]
    return out


def global_frontier_requires_every_worker(m):
    ft = m.frontier.FrontierTracker(2, 0)
    ft.advance_local(1000)
    out = [ft.global_frontier(), ft.commit_boundary()]
    assert out == [-1, -1]
    return out


def stall_detection_when_peer_stops_advancing(m):
    ft = m.frontier.FrontierTracker(2, 0)
    ft.advance_local(100, now=0.0)
    ft.observe(1, 100, now=0.0)
    out = [ft.stalled(now=100.0, timeout_s=30.0)]
    ft.advance_local(500, now=95.0)
    out.append(ft.stalled(now=100.0, timeout_s=30.0))
    out.append(ft.ages(100.0))
    ft.observe(1, 600, now=99.0)
    out.append(ft.stalled(now=100.0, timeout_s=30.0))
    assert out == [[], [1], {0: 5.0, 1: 100.0}, []]
    return out


def commit_boundary_matches_tick_boundary_on_synchronous_schedule(m):
    n = 3
    trackers = [m.frontier.FrontierTracker(n, w) for w in range(n)]
    out = []
    for t in [1000, 1002, 1004, 1006]:
        for ft in trackers:
            ft.advance_local(t)
        for w, ft in enumerate(trackers):
            for peer in range(n):
                if peer != w:
                    ft.observe(peer, trackers[peer].local())
        out.append([(ft.global_frontier(), ft.commit_boundary()) for ft in trackers])
        assert all(ft.commit_boundary() == t for ft in trackers)
    trackers[0].advance_local(1008)
    trackers[1].observe(0, 1008)
    out.append(trackers[1].commit_boundary())
    assert out[-1] == 1006
    return out


def commit_boundary_rounds_to_even(m):
    ft = m.frontier.FrontierTracker(1, 0)
    ft.advance_local(1001)
    assert ft.commit_boundary() == 1000
    return [ft.commit_boundary(), ft.ages(5.0)]


# -- QuiesceVotes ------------------------------------------------------------------------------


def _exchange_all(voters, payloads):
    for w, p in payloads.items():
        for v, qv in enumerate(voters):
            if v != w:
                qv.observe(w, p)


def quiesce_two_clean_rounds(m):
    voters = [m.frontier.QuiesceVotes(2, w, "term") for w in range(2)]
    out = []
    for _ in range(2):
        p = {w: voters[w].cast(3, 3, False) for w in range(2)}
        out.append(p)
        _exchange_all(voters, p)
        out.append([v.step() for v in voters])
    assert out[1] == [False, False] and out[3] == [True, True]
    return out


def quiesce_rejects_single_round_forgery(m):
    voters = [m.frontier.QuiesceVotes(2, w, "term") for w in range(2)]
    rounds = [((2, 1, False), (1, 2, False)), ((3, 1, False), (1, 3, True)),
              ((3, 1, False), (1, 3, False)), ((3, 1, False), (1, 3, False))]
    out = []
    for a, b in rounds:
        p = {0: voters[0].cast(*a), 1: voters[1].cast(*b)}
        _exchange_all(voters, p)
        out.append([v.step() for v in voters])
    assert out == [[False, False], [False, False], [False, False], [True, True]]
    return out


def quiesce_unbalanced_totals_never_complete(m):
    voters = [m.frontier.QuiesceVotes(2, w, "term") for w in range(2)]
    out = []
    for _ in range(4):
        p = {w: voters[w].cast(5, 4, False) for w in range(2)}
        _exchange_all(voters, p)
        out.append([v.step() for v in voters])
    assert not any(any(r) for r in out)
    return out + [voters[0].round, sorted(voters[0]._votes)]


def quiesce_rounds_stay_aligned_across_skew(m):
    a, b = m.frontier.QuiesceVotes(2, 0, "term"), m.frontier.QuiesceVotes(2, 1, "term")
    pa = a.cast(1, 1, False)
    out = [a.step(), a.round, a.needs_cast(), a.cast(9, 9, True)]  # a second cast is idempotent
    b.observe(0, pa)
    pb = b.cast(1, 1, False)
    a.observe(1, pb)
    out += [a.step(), b.step(), a.round, b.round]
    pa, pb = a.cast(1, 1, False), b.cast(1, 1, False)
    a.observe(1, pb)
    b.observe(0, pa)
    out += [a.step(), b.step()]
    assert out[0] is False and out[-2:] == [True, True] and out[6:8] == [1, 1]
    return out


def quiesce_phase_isolation(m):
    term = m.frontier.QuiesceVotes(2, 0, "term")
    term.observe(1, ("cw3", 0, 5, 5, False))
    assert 1 not in term._votes.get(0, {})
    return [dict(term._votes)]


# -- critpath: election, split, recorder, merges -----------------------------------------------


def _phases(m, **kw) -> dict:
    out = {p: 0.0 for p in m.crit.PHASES}
    out.update(kw)
    return out


def _wave(m, recorder, epoch, *, holder=2, dur=10.0, **phase_kw):
    order = [(recorder.worker_id, epoch, 0), (holder, epoch, 5)]
    return recorder.record_wave(
        epoch=epoch, T=epoch, t=1000.0 + epoch, duration_ms=dur, interval_ms=50.0,
        phases_ms=_phases(m, **phase_kw), settle_rounds=1, ready_order=order,
    )


def elect_holder_cases(m):
    e = m.crit.elect_holder
    out = [e([(0, 10, 0), (1, 10, 1), (3, 10, 4), (2, 10, 2)]),
           e([(0, 10, 0), (1, 12, 3), (2, 15, 3)]),
           e([(0, 10, 0), (2, 15, 3), (1, 15, 3)]),
           e([])]
    assert out == [3, 2, 1, None]
    return out


def attribute_holder_real_straggler_elected_by_arrival(m):
    got = m.crit.attribute_holder([(0, 10, 100.0), (1, 10, 100.08)],
                                  busy_ms={0: 200.0, 1: 5.0}, floor_ms=25.0)
    assert got == (1, "arrival")
    return got


def attribute_holder_jitter_falls_back_to_busy(m):
    got = m.crit.attribute_holder([(0, 10, 100.001), (1, 10, 100.0)],
                                  busy_ms={0: 140.0, 1: 60.0}, floor_ms=25.0)
    assert got == (0, "busy")
    return got


def attribute_holder_without_busy_data_keeps_arrival_verdict(m):
    order = [(0, 10, 100.001), (1, 10, 100.0)]
    out = [m.crit.attribute_holder(order, None, 25.0), m.crit.attribute_holder([], {0: 1.0})]
    assert out == [(0, "arrival"), (None, "arrival")]
    return out


def stage_split_names_largest_phase(m):
    critical, shares = m.crit.stage_split(_phases(m, sweep=2.0, frontier_wait=6.0, settle=2.0))
    assert critical == "frontier_wait"
    assert shares["frontier_wait"] == pytest.approx(0.6)
    assert sum(shares.values()) == pytest.approx(1.0)
    return critical, shares


def stage_split_ties_nothing_and_negatives(m):
    out = [m.crit.stage_split(_phases(m, sweep=3.0, settle=3.0))[0],
           m.crit.stage_split(_phases(m)),
           m.crit.stage_split(_phases(m, settle=-5.0, release=1.0))]
    assert out[0] == "sweep" and out[1][0] is None and out[2][0] == "release"
    assert out[2][1]["settle"] == 0.0
    return out


def wave_recorder_ring_is_bounded_and_tallies_holders(m):
    rec = m.crit.WaveRecorder(0, history=4)
    for ep in range(10):
        _wave(m, rec, ep, holder=ep % 2)
    snap = rec.snapshot()
    assert [d["epoch"] for d in rec.recent] == [6, 7, 8, 9]
    assert rec.held_total == {"0": 5, "1": 5}
    assert snap["last"]["epoch"] == 9 and snap["worker"] == 0
    return snap


def wave_recorder_document_shape(m):
    rec = m.crit.WaveRecorder(1, history=8)
    doc = _wave(m, rec, 3, holder=2, dur=12.5, frontier_wait=9.0, sweep=3.0)
    assert doc["holder"] == 2 and doc["critical_stage"] == "frontier_wait"
    assert doc["duration_ms"] == 12.5 and set(doc["phases_ms"]) == set(m.crit.PHASES)
    assert doc["ready_order"][-1] == (2, 3, 5) and "fin" not in doc
    return doc


def wave_recorder_marks_fin_wave(m):
    rec = m.crit.WaveRecorder(0, history=2)
    doc = rec.record_wave(epoch=9, T=9, t=1.0, duration_ms=1.0, interval_ms=1.0,
                          phases_ms=_phases(m, snapshot=1.0), settle_rounds=0,
                          ready_order=[(0, 9, 0)], fin=True)
    assert doc["fin"] is True
    return doc


def wave_recorder_env_knobs(m, monkeypatch):
    monkeypatch.setenv("PATHWAY_WAVE_HISTORY", "3")
    monkeypatch.setenv("PATHWAY_WAVE_ARRIVAL_FLOOR_MS", "7.5")
    rec = m.crit.WaveRecorder(0)
    out = [rec.recent.maxlen, rec.arrival_floor_ms]
    monkeypatch.delenv("PATHWAY_WAVE_HISTORY")
    monkeypatch.delenv("PATHWAY_WAVE_ARRIVAL_FLOOR_MS")
    rec = m.crit.WaveRecorder(0)
    out += [rec.recent.maxlen, rec.arrival_floor_ms]
    assert out == [3, 7.5, 128, 25.0]
    return out


def _two_worker_snaps(m, holder_a=2, holder_b=2):
    a, b = m.crit.WaveRecorder(0, history=8), m.crit.WaveRecorder(2, history=8)
    _wave(m, a, 1, holder=holder_a, dur=10.0, frontier_wait=8.0)
    _wave(m, b, 1, holder=holder_b, dur=14.0, settle=12.0)
    return {"0": a.snapshot(), "2": b.snapshot()}


def merge_worker_waves_unanimous_holder_and_max_phases(m):
    doc = m.crit.merge_worker_waves(_two_worker_snaps(m))
    wave = doc["recent"][0]
    assert doc["waves"] == 1 and wave["holder"] == 2 and wave["agreed"] is True
    assert wave["critical_stage"] == "settle" and wave["duration_ms"] == 14.0
    assert set(wave["workers"]) == {"0", "2"} and doc["holder_share"] == {"2": 1.0}
    return doc


def merge_worker_waves_disputed_holder_breaks_to_smaller_id(m):
    doc = m.crit.merge_worker_waves(_two_worker_snaps(m, holder_a=3, holder_b=1))
    assert doc["recent"][0]["agreed"] is False and doc["recent"][0]["holder"] == 1
    return doc


def merge_worker_waves_skips_missing_snapshots(m):
    snaps = _two_worker_snaps(m)
    snaps["5"] = None
    doc = m.crit.merge_worker_waves(snaps)
    assert doc["waves"] == 1
    return doc


def merge_process_waves_unions_workers_and_reelects(m):
    p0 = m.crit.merge_worker_waves(_two_worker_snaps(m))
    c = m.crit.WaveRecorder(4, history=8)
    _wave(m, c, 1, holder=4, dur=20.0, frontier_wait=18.0)
    _wave(m, c, 2, holder=4, dur=5.0, release=4.0)
    p1 = m.crit.merge_worker_waves({"4": c.snapshot()})
    merged = m.crit.merge_process_waves([p0, p1])
    wave1 = merged["recent"][0]
    assert merged["waves"] == 2 and set(wave1["workers"]) == {"0", "2", "4"}
    assert wave1["holder"] == 2 and wave1["agreed"] is False and wave1["duration_ms"] == 20.0
    assert merged["recent"][1]["holder"] == 4 and merged["held_total"] == {"2": 2, "4": 2}
    twice = m.crit.merge_process_waves([m.crit.merge_process_waves([p0]), p1])
    assert twice["recent"][0]["workers"] == wave1["workers"]
    assert twice["held_total"] == merged["held_total"]
    return merged, twice


def merge_process_waves_empty_inputs(m):
    doc = m.crit.merge_process_waves([None, None])
    assert doc["waves"] == 0 and doc["last"] is None
    return doc


# -- EngineStats: wave counters and the staged ingest->emit split -------------------------------


def note_wave_folds_doc_into_counters(m):
    stats = m.executor.EngineStats()
    rec = m.crit.WaveRecorder(0, history=4)
    doc = _wave(m, rec, 1, holder=2, dur=10.0, frontier_wait=8.0, sweep=2.0)
    stats.note_wave(doc, 10_000_000)
    stats.note_wave(doc, 12_000_000)
    assert stats.waves_total == 2 and stats.wave_held_total == {"2": 2}
    assert stats.wave_stage_ns["frontier_wait"] == 16_000_000
    assert stats.wave_duration._count == 2
    return [stats.waves_total, stats.wave_held_total, stats.wave_stage_ns,
            stats.wave_duration.snapshot()]


def note_e2e_stages_sum_to_total_latency(m):
    stats = m.executor.EngineStats()
    now = time.time_ns()
    stats.note_e2e(now - 100_000_000, route_ns=10_000_000, dwell_ns=20_000_000,
                   sweep_t0_wall_ns=now - 5_000_000)
    staged = sum(stats.stage_hists[s]._sum for s in m.executor.E2E_STAGES)
    assert staged == stats.e2e_latency_hist._sum
    assert stats.stage_hists["ingest_route"]._sum == 10_000_000
    assert stats.stage_hists["inbox_dwell"]._sum == 20_000_000
    assert stats.stage_hists["commit_deliver"]._sum >= 5_000_000
    # a claimed route past the whole latency is clamped, never negative
    stats = m.executor.EngineStats()
    stats.note_e2e(time.time_ns() - 1_000_000, route_ns=10_000_000_000)
    staged = sum(stats.stage_hists[s]._sum for s in m.executor.E2E_STAGES)
    assert staged == stats.e2e_latency_hist._sum
    return [m.executor.E2E_STAGES, stats.stage_hists["inbox_dwell"]._sum]


CASES = [
    local_advance_is_monotone,
    broadcast_merge_across_workers,
    global_frontier_requires_every_worker,
    stall_detection_when_peer_stops_advancing,
    commit_boundary_matches_tick_boundary_on_synchronous_schedule,
    commit_boundary_rounds_to_even,
    quiesce_two_clean_rounds,
    quiesce_rejects_single_round_forgery,
    quiesce_unbalanced_totals_never_complete,
    quiesce_rounds_stay_aligned_across_skew,
    quiesce_phase_isolation,
    elect_holder_cases,
    attribute_holder_real_straggler_elected_by_arrival,
    attribute_holder_jitter_falls_back_to_busy,
    attribute_holder_without_busy_data_keeps_arrival_verdict,
    stage_split_names_largest_phase,
    stage_split_ties_nothing_and_negatives,
    wave_recorder_ring_is_bounded_and_tallies_holders,
    wave_recorder_document_shape,
    wave_recorder_marks_fin_wave,
    merge_worker_waves_unanimous_holder_and_max_phases,
    merge_worker_waves_disputed_holder_breaks_to_smaller_id,
    merge_worker_waves_skips_missing_snapshots,
    merge_process_waves_unions_workers_and_reelects,
    merge_process_waves_empty_inputs,
    note_wave_folds_doc_into_counters,
    note_e2e_stages_sum_to_total_latency,
]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_same_events_same_results(case):
    assert case(PACKAGES["torch"]) == case(PACKAGES["jax"])


def test_wave_recorder_env_knobs_in_both_packages(monkeypatch):
    assert (wave_recorder_env_knobs(PACKAGES["torch"], monkeypatch)
            == wave_recorder_env_knobs(PACKAGES["jax"], monkeypatch))


def test_the_port_leaves_out_only_the_report_renderer():
    # the report renderer came with the observability plane: the port now leaves out nothing
    assert tcrit.__all__ == jcrit.__all__
    assert tcrit.PHASES == jcrit.PHASES
    assert tcrit.DEFAULT_HISTORY == jcrit.DEFAULT_HISTORY
    assert tcrit.DEFAULT_ARRIVAL_FLOOR_MS == jcrit.DEFAULT_ARRIVAL_FLOOR_MS
