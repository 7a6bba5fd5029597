"""The port's program auditor (fps_tpu_torch.analysis) against the JAX
package's.

* **Parity on the same text**: every toy fixture and seeded mutation of
  ``tests/test_analysis.py`` goes through both packages' ``certify``, and
  the certificate JSON is equal; the JAX package's real MF program (lowered
  on its 8-device CPU mesh) profiles the same through both parsers.
* **The port's programs**: the record of every ``audit_programs`` row
  certifies clean on the ``(1, 8)`` mesh against its pinned budget and on
  ``(2, 4)`` against the structural passes; each default pass has a
  mutation of a real port program that fires it and no other pass.
* **The trainer's entry points**: ``Trainer(audit=...)`` records the first
  call of each program and changes no table and no kernel call;
  ``lowered_chunk_text`` / ``lowered_megastep_text`` /
  ``tiering.lowered_plan_text`` return certifiable records and leave the
  trainer as they found it; the megastep census is K-independent and two
  re-ranks give byte-identical records.
* **The offline command line** profiles saved records and StableHLO with
  torch and jax unimportable.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fps_tpu import analysis as janalysis
from fps_tpu_torch import analysis as tanalysis
from fps_tpu_torch.analysis.record import RECORD_HEADER, ProgramRecord
from fps_tpu_torch.examples import audit_programs as ap
from fps_tpu_torch.parallel import collectives
from test_analysis import MARK, RECONCILE_PSUM, RECONCILE_RS, TOY

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(ROOT, "fps_tpu_torch", "examples", "audit_programs.py")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the files run beside others under xdist, and
    the small tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _insert(extra: str) -> str:
    return TOY.replace(MARK, extra + MARK)


# ---------------------------------------------------------------------------
# Parity on the same StableHLO text.
# ---------------------------------------------------------------------------

BASE_KW = dict(name="toy", max_collectives=2, max_collective_bytes=4096,
               per_kind_max={"all_gather": 1, "all_to_all": 1},
               donated_tables=True, max_float_bits=32)
TIERED_KW = dict(BASE_KW, require_shard_psum=True, hot_reconcile_bytes=1024,
                 shard_group_size=8)
WIDEN = ("    %9 = stablehlo.convert %2 : (tensor<64x8xbf16>) -> "
         "tensor<64x8xf32>\n")
F64 = "    %9 = stablehlo.add %2, %2 : tensor<64x8xf64>\n"
CALLBACK = ('    %9 = stablehlo.custom_call @xla_python_cpu_callback(%2) '
            '{api_version = 2 : i32} : (tensor<64x8xf32>) -> '
            'tensor<64x8xf32>\n')
INFEED = ('    %9 = "stablehlo.infeed"(%2) : (!stablehlo.token) -> '
          '(tensor<4xf32>, !stablehlo.token)\n')
NO_A2A = "\n".join(line for line in TOY.splitlines()
                   if "all_to_all" not in line)

# (id, text, contract kwargs): every toy fixture and seeded mutation of
# tests/test_analysis.py.
TOY_CASES = [
    ("clean", TOY, BASE_KW),
    ("extra_psum", _insert(RECONCILE_PSUM), BASE_KW),
    ("per_kind", TOY, dict(per_kind_max={"all_gather": 0})),
    ("removed_exact", NO_A2A, dict(BASE_KW, exact_collectives=True)),
    ("removed_ceiling", NO_A2A, BASE_KW),
    ("clean_exact", TOY, dict(BASE_KW, exact_collectives=True)),
    ("unpinned_kind", TOY.replace('"stablehlo.all_to_all"',
                                  '"stablehlo.collective_permute"'),
     dict(BASE_KW, exact_collectives=True)),
    ("undonated", TOY.replace("jax.buffer_donor = true, ", ""), BASE_KW),
    ("widening_convert", _insert(WIDEN), BASE_KW),
    ("f64_op", _insert(F64), BASE_KW),
    ("host_callback", _insert(CALLBACK), BASE_KW),
    ("host_callback_allowed", _insert(CALLBACK),
     dict(BASE_KW, allow_host_transfers=("xla_python_cpu_callback",))),
    ("infeed", _insert(INFEED), BASE_KW),
    ("missing_reconcile", TOY, TIERED_KW),
    ("reconcile_psum", _insert(RECONCILE_PSUM),
     dict(TIERED_KW, max_collectives=3, max_collective_bytes=8192,
          per_kind_max={"all_gather": 1, "all_to_all": 1,
                        "all_reduce": 1})),
    ("reconcile_rs", _insert(RECONCILE_RS),
     dict(TIERED_KW, max_collectives=3, max_collective_bytes=8192,
          per_kind_max={"all_gather": 1, "all_to_all": 1,
                        "reduce_scatter": 1})),
    ("reconcile_rs_small", _insert(RECONCILE_RS),
     dict(TIERED_KW, max_collectives=3, max_collective_bytes=8192,
          per_kind_max={"all_gather": 1, "all_to_all": 1,
                        "reduce_scatter": 1}, hot_reconcile_bytes=1 << 20)),
    ("default_contract", _insert(RECONCILE_PSUM), None),
]


@pytest.mark.parametrize("text,kw", [c[1:] for c in TOY_CASES],
                         ids=[c[0] for c in TOY_CASES])
def test_toy_certificates_equal_across_packages(text, kw):
    want = janalysis.certify(
        text, janalysis.ProgramContract(**kw) if kw is not None else None,
        program="toy").to_json()
    got = tanalysis.certify(
        text, tanalysis.ProgramContract(**kw) if kw is not None else None,
        program="toy").to_json()
    assert got == want
    assert json.loads(json.dumps(got)) == got


@pytest.mark.parametrize("text", [TOY, _insert(RECONCILE_PSUM),
                                  _insert(RECONCILE_RS), _insert(CALLBACK)],
                         ids=["toy", "psum", "rs", "callback"])
def test_toy_parses_and_profiles_equal_across_packages(text):
    j = janalysis.HloProgram.from_text(text)
    t = tanalysis.HloProgram.from_text(text)
    assert [dataclasses.astuple(o) for o in t.ops] == [
        dataclasses.astuple(o) for o in j.ops]
    assert [dataclasses.astuple(a) for a in t.args] == [
        dataclasses.astuple(a) for a in j.args]
    assert [dataclasses.astuple(r) for r in t.results] == [
        dataclasses.astuple(r) for r in j.results]
    for min_bytes in (0, 1024):
        assert [c.as_tuple() for c in tanalysis.collective_profile(
            text, min_bytes)] == [c.as_tuple() for c in
                                  janalysis.collective_profile(text,
                                                               min_bytes)]
        assert tanalysis.count_collectives(text, min_bytes) == \
            janalysis.count_collectives(text, min_bytes)


def test_parser_helpers_equal_across_packages():
    from fps_tpu.analysis import hlo as jhlo
    from fps_tpu_torch.analysis import hlo as thlo

    for s in ("(tensor<8x8xf32>) -> tensor<64x8xf32>", "tensor<4xi32>",
              "tensor<f32>", "(tensor<8xbf16>) -> tensor<8xf32>",
              "tensor<4xf64>"):
        assert thlo.tensor_bytes(s) == jhlo.tensor_bytes(s)
        assert thlo.float_widths(s) == jhlo.float_widths(s)
    sig = ('func.func public @main(%arg0: tensor<64x8xf32> {mhlo.sharding = '
           '"{devices=[8,1]<=[8]}", tf.aliasing_output = 0 : i32}) -> '
           '(tensor<64x8xf32> {jax.result_info = "[0][\'tab\']"}) {')
    got, want = (thlo.HloProgram._parse_main(sig),
                 jhlo.HloProgram._parse_main(sig))
    assert [[dataclasses.astuple(x) for x in part] for part in got] == [
        [dataclasses.astuple(x) for x in part] for part in want]


def test_default_passes_and_auditor_equal_across_packages():
    assert [p.name for p in tanalysis.DEFAULT_PASSES] == [
        p.name for p in janalysis.DEFAULT_PASSES]
    assert set(tanalysis.__all__) >= set(janalysis.__all__)
    for a in (True, "strict", None, False):
        j, t = janalysis.as_auditor(a), tanalysis.as_auditor(a)
        assert (j is None) == (t is None)
        if j is not None:
            assert j.strict == t.strict
    with pytest.raises(TypeError):
        tanalysis.as_auditor(17)


@pytest.fixture(scope="module")
def jax_mf_hlo(devices8):
    """The JAX package's MF step program, lowered on its 8-device mesh."""
    import jax

    from fps_tpu.core.driver import num_workers_of
    from fps_tpu.core.ingest import multi_epoch_chunks
    from fps_tpu.models.matrix_factorization import MFConfig, online_mf
    from fps_tpu.parallel.mesh import make_ps_mesh
    from fps_tpu.utils.datasets import synthetic_ratings

    mesh = make_ps_mesh(num_shards=8, num_data=1)
    trainer, _ = online_mf(mesh, MFConfig(num_users=96, num_items=64,
                                          rank=4))
    data = synthetic_ratings(96, 64, 1500, rank=3, seed=3)
    chunk = next(iter(multi_epoch_chunks(
        data, 1, num_workers=num_workers_of(mesh), local_batch=32,
        steps_per_chunk=4, route_key="user", seed=11)))
    return trainer.lowered_chunk_text(chunk, "sync")


def test_jax_mf_program_profiles_equal_across_packages(jax_mf_hlo):
    for min_bytes in (0, 1024):
        assert [c.as_tuple() for c in tanalysis.collective_profile(
            jax_mf_hlo, min_bytes)] == [
                c.as_tuple() for c in janalysis.collective_profile(
                    jax_mf_hlo, min_bytes)]
    j = janalysis.HloProgram.from_text(jax_mf_hlo)
    t = tanalysis.HloProgram.from_text(jax_mf_hlo)
    assert len(t.ops) == len(j.ops) > 0
    assert [a.donated for a in t.args] == [a.donated for a in j.args]
    assert (tanalysis.certify(jax_mf_hlo, program="mf").to_json()
            == janalysis.certify(jax_mf_hlo, program="mf").to_json())


# ---------------------------------------------------------------------------
# The record.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh8():
    return ap.make_mesh((1, 8))


@pytest.fixture(scope="module")
def mf_record(mesh8):
    return ap.build_mf(mesh8)


def test_record_text_round_trips_and_models_the_program(mf_record):
    rec = ProgramRecord.from_text(mf_record)
    assert mf_record.startswith(RECORD_HEADER)
    assert rec.to_text() == mf_record
    assert ProgramRecord(rec.program, rec.ops, rec.args,
                         rec.results).to_text() == mf_record
    assert rec.program == "chunk/sync"
    # The donated canonical table, as argument and [0] result.
    assert [(a.type, a.donated) for a in rec.args] == [
        ("tensor<8x8xf32>", True)]
    assert [r.info for r in rec.results] == ["[0]['item_factors']"]
    # Every op's line is its line in the text.
    lines = mf_record.splitlines()
    for op in rec.ops:
        assert json.loads(lines[op.line - 1])["op"] == op.kind
    # The pull's and push's collectives over the shard axis, once a step.
    prof = [(c.kind, c.payload_bytes) for c in rec.profile()]
    assert prof == [("all_gather", 1024), ("reduce_scatter", 8192),
                    ("all_gather", 1024), ("all_gather", 8192)]
    assert all(op.count == ap.STEPS for op in rec.collectives())
    assert rec.collectives()[0].replica_groups == (tuple(range(8)),)
    # Each worker's K1 pull and K2 push, and the user rows' own K1 / K2:
    # every step, every position.
    assert rec.kernel_counts() == {"gather_rows": 2 * 8 * ap.STEPS,
                                   "scatter_add": 2 * 8 * ap.STEPS}
    assert rec.host_reads() == 0
    # The metrics' sum is an all_reduce over the whole mesh, below the
    # payload threshold.
    [metrics] = [op for op in rec.by_kind("all_reduce")]
    assert metrics.function == "_sum_metrics" and metrics.payload_bytes < 1024


def test_record_is_deterministic(mesh8, mf_record):
    assert ap.build_mf(mesh8) == mf_record


@pytest.mark.parametrize("shape", [(1, 8), (2, 4)], ids=["1x8", "2x4"])
@pytest.mark.parametrize("name", list(ap.BUILDERS))
def test_every_audit_row_certifies_clean(name, shape):
    mesh = ap.make_mesh(shape)
    text = ap.BUILDERS[name](mesh)
    cert = tanalysis.certify(text, ap.contract_for(
        name, pinned=shape == (1, 8), shards=shape[1]), program=name)
    assert cert.ok, [v.summary for v in cert.violations]
    if shape == (1, 8):
        b = ap.BUDGETS[name]
        assert cert.collective_count == b["max_collectives"]
        assert cert.collective_bytes == b["max_collective_bytes"]
    if name in ap.TIERED_ROWS:
        # The reconcile in the census: a reduce_scatter over the shard
        # groups of at least H * dim * itemsize.
        rs = [c for c in cert.collectives if c.kind == "reduce_scatter"
              and len(c.replica_groups[0]) == shape[1]
              and c.payload_bytes >= 32 * ap.RANK * 4]
        assert rs


def test_audit_rows_equal_to_the_reference_census_where_routes_agree(
        mesh8):
    """Where the port's routes are the JAX package's (the forced gathered
    and the compacted partial head, iALS's accumulate), the census is the
    JAX package's pinned one (AUDIT_r13.json)."""
    with open(os.path.join(ROOT, "AUDIT_r13.json")) as f:
        ref = json.load(f)["audit_programs"]
    for name in ("mf_tiered_gathered", "mf_tiered_compact", "ials"):
        cert = tanalysis.certify(ap.BUILDERS[name](mesh8), program=name)
        want = ref[name]["collectives"]
        assert (cert.collective_count, cert.collective_bytes) == (
            want["count"], want["bytes"]), name
        assert cert.per_kind() == want["per_kind"], name


# ---------------------------------------------------------------------------
# Each default pass has a mutation of a real port program.
# ---------------------------------------------------------------------------


def _tap_psum(tables, batches, states, t):
    mesh = ap.make_mesh((1, 8))
    out = collectives.psum(mesh, [torch.ones(512) for _ in range(8)],
                           "shard")
    return [{"x": o[:1]} for o in out]


_tap_psum.collective = True


def _tap_item(tables, batch, state, t):
    return {"x": torch.tensor(float(batch["rating"].sum().item()))}


def _tap_f64(tables, batch, state, t):
    return {"x": batch["rating"].to(torch.float64).sum()}


def _mutant(mesh, what, monkeypatch):
    trainer, chunks = ap._mf_pieces(
        mesh, **(dict(hot_tier=32, hot_sync_every=2)
                 if what == "no_reconcile" else {}))
    if what in ("psum", "item", "f64"):
        tap = {"psum": _tap_psum, "item": _tap_item, "f64": _tap_f64}[what]
        trainer.config = dataclasses.replace(trainer.config, step_tap=tap)
    elif what == "undonated":
        trainer.config = dataclasses.replace(trainer.config, donate=False)
    elif what == "no_reconcile":
        monkeypatch.setattr(type(trainer), "_reconcile",
                            lambda self, tables, tier: tables)
    return trainer.lowered_chunk_text(next(iter(chunks)))


MUTATIONS = [("psum", "mf", True, "collective_budget"),
             ("item", "mf", True, "host_transfer"),
             ("undonated", "mf", True, "donation"),
             ("f64", "mf", True, "dtype_drift"),
             ("no_reconcile", "mf_tiered", False, "replica_consistency")]


@pytest.mark.parametrize("what,row,pinned,fires", MUTATIONS,
                         ids=[m[0] for m in MUTATIONS])
def test_every_default_pass_has_a_mutation_on_a_port_program(
        what, row, pinned, fires, mesh8, monkeypatch):
    contract = ap.contract_for(row, pinned=pinned)
    clean = tanalysis.certify(_mutant(mesh8, None, monkeypatch) if
                              row == "mf" else ap.BUILDERS[row](mesh8),
                              contract)
    assert clean.ok
    cert = tanalysis.certify(_mutant(mesh8, what, monkeypatch), contract)
    assert {v.pass_name for v in cert.violations} == {fires}, [
        v.summary for v in cert.violations]


def test_every_default_pass_is_mutated():
    assert {m[3] for m in MUTATIONS} == {
        p.name for p in tanalysis.DEFAULT_PASSES}


def test_host_read_names_its_site_and_the_vote_site_is_allowed(mesh8):
    tr, chunks = ap._mf_pieces(mesh8)
    tr.config = dataclasses.replace(tr.config, step_tap=_tap_item)
    rec = ProgramRecord.from_text(tr.lowered_chunk_text(next(iter(chunks))))
    [site] = {op.site_function for op in rec.host_transfers()}
    assert site.endswith("test_torch_analysis.py:_tap_item")
    assert rec.host_reads() == 8 * ap.STEPS
    allowed = dataclasses.replace(
        ap.contract_for("mf"), allow_host_transfers=(site,))
    assert tanalysis.certify(rec, allowed).ok
    mega = ProgramRecord.from_text(ap.build_mf_megastep(mesh8))
    [vote] = mega.host_transfers()
    assert (vote.site_function, vote.custom_target, vote.count) == (
        "fps_tpu_torch/core/megastep.py:group_votes", "tolist", 1)
    assert not tanalysis.certify(mega, dataclasses.replace(
        ap.contract_for("mf_megastep"), allow_host_transfers=())).ok


def test_hot_fold_f64_sites_are_allowed_and_nothing_else():
    """The hot folds take sqrt and beta ** t in float64 and round once:
    contract_for_trainer allows exactly those two sites when such a fold is
    on."""
    from fps_tpu_torch.analysis.contract import HOT_FOLD_F64_SITES
    from fps_tpu_torch.core.api import HotFold

    mesh = ap.make_mesh((1, 8))
    trainer, chunks = ap._mf_pieces(mesh, hot_tier=64, hot_sync_every=2)
    for name in trainer.server_logic:
        trainer.server_logic[name] = dataclasses.replace(
            trainer.server_logic[name], hot_fold=HotFold(kind="adam"))
    text = trainer.lowered_chunk_text(next(iter(chunks)))
    rec = ProgramRecord.from_text(text)
    wide = {op.site_function for op in rec.ops if "f64" in op.text}
    assert wide == set(HOT_FOLD_F64_SITES)
    contract = tanalysis.contract_for_trainer(trainer)
    assert contract.allow_wide_float_sites == HOT_FOLD_F64_SITES
    assert tanalysis.certify(rec, contract).ok
    cert = tanalysis.certify(rec, dataclasses.replace(
        contract, allow_wide_float_sites=()))
    assert {v.pass_name for v in cert.violations} == {"dtype_drift"}
    assert contract.to_json()["allow_wide_float_sites"] == list(
        HOT_FOLD_F64_SITES)
    assert "allow_wide_float_sites" not in tanalysis.ProgramContract(
    ).to_json()


# ---------------------------------------------------------------------------
# Trainer(audit=...).
# ---------------------------------------------------------------------------


class _FakeRecorder:
    def __init__(self):
        self.incs, self.events = [], []

    def inc(self, name, value=1.0, **labels):
        self.incs.append((name, value, labels))

    def event(self, etype, **fields):
        self.events.append((etype, fields))


def _kernel_calls(monkeypatch):
    """A count of each plain kernel's calls (the CPU's launches)."""
    from fps_tpu_torch.ops import kernels

    calls = {}
    for name in ("gather_rows_plain", "scatter_add_plain",
                 "gather_rows_dim1_plain", "scatter_add_dim1_plain",
                 "scatter_add_packed_plain"):
        fn = getattr(kernels, name)

        def spy(*a, _fn=fn, _n=name, **k):
            calls[_n] = calls.get(_n, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(kernels, name, spy)
    return calls


def _flat(tree, prefix=""):
    """A metrics tree as ``{path: list}``."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: np.asarray(tree).tolist()}


def _mf_run(mesh, *, audit=None, chunks_n=2, tiered=False):
    kw = dict(hot_tier=32, hot_sync_every=2) if tiered else {}
    trainer, chunks = ap._mf_pieces(mesh, **kw)
    trainer.audit = audit
    tables, ls = trainer.init_state(0)
    tables, ls, m = trainer.fit_stream(tables, ls,
                                       iter(list(chunks)[:chunks_n]), 1)
    return trainer, tables, m


def test_trainer_audit_certifies_the_first_call(mesh8):
    trainer, _, m = _mf_run(mesh8, audit=True)
    auditor = trainer.audit
    assert isinstance(auditor, tanalysis.ProgramAuditor)
    assert [c.program for c in auditor.certificates] == ["chunk/sync"]
    assert auditor.certificates[0].ok
    assert len(m) == 2


@pytest.mark.parametrize("tiered", [False, True], ids=["mf", "mf_tiered"])
def test_trainer_audit_changes_no_table_and_no_kernel_call(
        mesh8, tiered, monkeypatch):
    calls = _kernel_calls(monkeypatch)
    _, ta, ma = _mf_run(mesh8, audit=True, tiered=tiered)
    on = dict(calls)
    calls.clear()
    _, tb, mb = _mf_run(mesh8, audit=None, tiered=tiered)
    assert on == calls and on
    assert ta.keys() == tb.keys()
    for name in ta:
        assert torch.equal(torch.stack(list(ta[name])),
                           torch.stack(list(tb[name]))), name
    assert _flat(ma) == _flat(mb)


def test_trainer_audit_reports_through_the_recorder(mesh8):
    rec = _FakeRecorder()
    impossible = tanalysis.ProgramContract(name="impossible",
                                           max_collectives=0)
    trainer, _, _ = _mf_run(mesh8, audit=tanalysis.ProgramAuditor(
        contract=impossible, recorder=rec))
    assert not trainer.audit.certificates[0].ok
    assert any(n == "analysis.contract_violations" for n, _, _ in rec.incs)
    assert rec.events[0][0] == "analysis.contract_violation"
    # Through the trainer's own obs recorder: the registered names.
    from fps_tpu_torch import obs

    mem = obs.MemorySink()
    trainer2, chunks = ap._mf_pieces(mesh8)
    trainer2.recorder = obs.Recorder(sinks=[mem])
    trainer2.audit = True
    tables, ls = trainer2.init_state(0)
    trainer2.run_chunk(tables, ls, next(iter(chunks)), 1)
    assert trainer2.recorder.counter_value(
        "analysis.certified_programs") == 1


def test_trainer_audit_strict_raises_after_the_call(mesh8):
    impossible = tanalysis.ProgramContract(name="impossible",
                                           max_collectives=0)
    with pytest.raises(tanalysis.ContractViolationError) as ei:
        _mf_run(mesh8, audit=tanalysis.ProgramAuditor(contract=impossible,
                                                      strict=True))
    assert ei.value.certificate.program == "chunk/sync"
    # "strict" with the trainer's own contract passes a clean program.
    trainer, _, m = _mf_run(mesh8, audit="strict")
    assert trainer.audit.strict and trainer.audit.certificates[0].ok


def test_trainer_audit_never_swallows_the_calls_exception(mesh8):
    from fps_tpu_torch.analysis import record

    def boom(tables, batch, state, t):
        raise RuntimeError("tap failed")

    trainer, chunks = ap._mf_pieces(mesh8)
    trainer.config = dataclasses.replace(trainer.config, step_tap=boom)
    trainer.audit = "strict"
    tables, ls = trainer.init_state(0)
    with pytest.raises(RuntimeError, match="tap failed"):
        trainer.run_chunk(tables, ls, next(iter(chunks)), 1)
    assert record.active() is None
    assert trainer.audit.certificates == []


def test_trainer_audit_off_and_false(mesh8):
    from fps_tpu_torch.core.driver import Trainer

    trainer, _, _ = _mf_run(mesh8, audit=None)
    assert trainer.audit is None and not trainer._audited
    tr, _ = ap._mf_pieces(mesh8)
    assert Trainer(mesh8, tr.store, tr.logic, tr.server_logic,
                   config=tr.config, audit=False).audit is None
    trainer2, _, m = _mf_run(mesh8, audit=False)
    assert len(m) == 2 and not trainer2._audited
    assert not isinstance(trainer2.audit, tanalysis.ProgramAuditor)


def test_trainer_audit_bad_value_fails_at_construction(mesh8):
    from fps_tpu_torch.core.driver import Trainer

    tr, _ = ap._mf_pieces(mesh8)
    with pytest.raises(TypeError, match="audit"):
        Trainer(mesh8, tr.store, tr.logic, tr.server_logic,
                config=tr.config, audit="strictt")


def test_trainer_audit_labels_indexed_and_megastep(mesh8):
    trainer, plan = ap._mf_megastep_pieces(mesh8)
    trainer.audit = True
    tables, ls = trainer.init_state(0)
    tables, ls, _ = trainer.run_megastep(tables, ls, plan, 1,
                                         chunks_per_dispatch=2)
    trainer.run_indexed(tables, ls, plan, 2)
    assert [c.program for c in trainer.audit.certificates] == [
        "megastep/sync", "indexed/sync"]
    assert all(c.ok for c in trainer.audit.certificates), [
        v.summary for c in trainer.audit.certificates
        for v in c.violations]


# ---------------------------------------------------------------------------
# lowered_*_text leave the trainer as they found it.
# ---------------------------------------------------------------------------


def _state(trainer, tables):
    return ({k: torch.stack(list(v)).clone() for k, v in tables.items()},
            trainer.retierer.snapshot() if trainer.retierer else None)


def _same(a, b):
    assert a[0].keys() == b[0].keys()
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    if a[1] is not None:
        assert a[1]["re_ranks"] == b[1]["re_ranks"]
        assert a[1]["checks"] == b[1]["checks"]
        for k in a[1]["hot_ids"]:
            np.testing.assert_array_equal(a[1]["hot_ids"][k],
                                          b[1]["hot_ids"][k])


def test_lowered_chunk_text_changes_nothing_a_later_run_computes(mesh8):
    runs = []
    for lower in (False, True):
        trainer, chunks = ap._mf_retier_pieces(mesh8)
        chunks = list(chunks)
        tables, ls = trainer.init_state(0)
        tables, ls, _ = trainer.fit_stream(tables, ls, iter(chunks[:2]), 1)
        before = _state(trainer, trainer.store.tables)
        if lower:
            text = trainer.lowered_chunk_text(chunks[0])
            assert text.startswith(RECORD_HEADER)
            _same(before, _state(trainer, trainer.store.tables))
        tables, ls, _ = trainer.fit_stream(tables, ls, iter(chunks[2:4]), 2)
        runs.append(_state(trainer, tables))
    _same(runs[0], runs[1])


def test_lowered_megastep_text_changes_nothing_and_checks_the_cadence(
        mesh8):
    from fps_tpu_torch.tiering import MegastepTick

    runs = []
    for lower in (False, True):
        trainer, plan = ap._mf_megastep_pieces(mesh8)
        if lower:
            text = trainer.lowered_megastep_text(
                plan, chunks_per_dispatch=4, tick=MegastepTick(
                    check_every=2))
            assert tanalysis.certify(text, tanalysis.contract_for_trainer(
                trainer, program="megastep")).ok
            assert trainer.retierer is None
        tables, ls = trainer.init_state(0)
        tables, ls, _ = trainer.run_megastep(tables, ls, plan, 1,
                                             chunks_per_dispatch=2)
        runs.append(_state(trainer, tables))
    _same(runs[0], runs[1])
    with pytest.raises(ValueError, match="multiple"):
        trainer.lowered_megastep_text(plan, chunks_per_dispatch=3,
                                      tick=MegastepTick(check_every=2))
    with pytest.raises(ValueError, match="mode"):
        trainer.lowered_megastep_text(plan, chunks_per_dispatch=2,
                                      mode="ssp")


def test_megastep_census_is_k_independent_and_reranks_are_identical(
        mesh8):
    assert ap.megastep_k_independence(mesh8, ks=(4, 16))
    assert ap.rerank_byte_identity(mesh8)


def test_lowered_plan_text_records_the_planned_program(mesh8):
    from fps_tpu_torch import tiering
    from fps_tpu_torch.core.store import TableSpec

    specs = {"t": TableSpec("t", 256, 8)}
    plan = tiering.TierPlan(hot_tier=64, hot_sync_every=2, dense=False,
                            coverage=0.5, reason="test")
    static = tiering.lowered_plan_text(mesh8, specs, {}, hot_sync_every=1)
    tiered = tiering.lowered_plan_text(mesh8, specs, {"t": plan},
                                       hot_sync_every=2)
    kinds = [c.kind for c in tanalysis.collective_profile(tiered)]
    assert kinds.count("reduce_scatter") == 2  # the pull's and reconcile's
    assert len(tanalysis.collective_profile(static)) == 4


# ---------------------------------------------------------------------------
# The offline command line.
# ---------------------------------------------------------------------------


def test_audit_programs_offline_needs_neither_torch_nor_jax(tmp_path,
                                                            mf_record):
    toy = tmp_path / "toy.hlo.txt"
    toy.write_text(TOY)
    rec = tmp_path / "mf.record.txt"
    rec.write_text(mf_record)
    code = (
        "import sys, runpy\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['torch'] = None\n"
        f"sys.argv = ['audit_programs.py', '--hlo', {str(toy)!r}, "
        f"'--hlo', {str(rec)!r}]\n"
        f"runpy.run_path({TOOL!r}, run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout)
    assert out[str(toy)]["format"] == "stablehlo"
    assert (out[str(toy)]["collectives"], out[str(toy)]["bytes"]) == (2,
                                                                      4096)
    assert out[str(rec)]["format"] == "record"
    assert (out[str(rec)]["collectives"], out[str(rec)]["bytes"]) == (
        ap.BUDGETS["mf"]["max_collectives"],
        ap.BUDGETS["mf"]["max_collective_bytes"])


def test_audit_programs_cli_certifies_its_rows(tmp_path):
    out = tmp_path / "certs.json"
    proc = subprocess.run(
        [sys.executable, "-m", "fps_tpu_torch.examples.audit_programs",
         "--only", "mf,mf_retier,ials", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(out.read_text())
    assert doc["ok"] and doc["rerank_byte_identical"]
    assert set(doc["audit_programs"]) == {"mf", "mf_retier", "ials"}
    assert json.loads(proc.stdout.splitlines()[-1])["ok"]
