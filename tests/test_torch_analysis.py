"""``repro_torch.analysis``: the port's static-analysis suite, held to
``repro.analysis`` on the same inputs, and the layering repairs and the
train-step key it led to.

* Parity: the port's engine, import graph, baseline and RA201 give the
  reference's findings (rule, file, line, key, message) on the
  reference's fixtures and on both source trees; where RA401 and RA501
  differ only by their tables, the shared parts (which functions are hot,
  which files are thin clients, how a laundered re-export resolves) give
  the reference's answers on twin inputs.
* Each port rule has a torch-flavoured bad fixture that turns red with
  its id and a good twin that stays clean
  (``tests/torch_analysis_fixtures/``); RA101 and RA301 are refused.
* RA201 turns red when a ``fusion_mode`` kwarg is injected into the
  port's real ``ExecutionPlan.serve_executable``.
* The shipped tree is clean under ``analysis_baseline_torch.json``,
  whose one entry is justified; the baseline round-trips and its
  hygiene errors fire; the CLI's exit codes and JSON report.
* Importing the package and running its CLI loads no torch, numpy, jax
  or ``repro`` module.
* The repairs: each thin client no longer reaches a banned module, and
  a train step built before ``shard_model`` is not served after it.
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import ast
import json
import os
import re
import subprocess
import sys

import pytest

import repro.analysis as ref
from repro.analysis.graph import ImportGraph as RefImportGraph
from repro.analysis.rules import hotpath as ref_hotpath
from repro.analysis.rules import layering as ref_layering
from repro_torch.analysis import (
    ALL_RULES,
    NOT_APPLICABLE,
    Baseline,
    analyze,
    get_rules,
    load_tree,
    write_baseline,
)
from repro_torch.analysis.astutil import call_name
from repro_torch.analysis.graph import ImportGraph
from repro_torch.analysis.rules import hotpath, layering

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
SRC_REPRO = os.path.join(SRC, "repro")
SRC_TORCH = os.path.join(SRC, "repro_torch")
REF_FIXTURES = os.path.join(os.path.dirname(__file__), "analysis_fixtures")
FIXTURES = os.path.join(os.path.dirname(__file__), "torch_analysis_fixtures")
BASELINE = os.path.join(ROOT, "analysis_baseline_torch.json")

RULE_FIXTURES = {
    "RA201": ("cachekey_bad.py", "cachekey_good.py"),
    "RA401": ("hotpath_bad.py", "hotpath_good.py"),
    "RA501": ("layering_bad", "layering_good"),
}


@pytest.fixture(autouse=True)
def _at_root(monkeypatch):
    """Display paths (and so baseline idents) are relative to the working
    directory, as the CLI run from the repository's root sees them."""
    monkeypatch.chdir(ROOT)


def run_rule(rule_id, target):
    return analyze([os.path.join(FIXTURES, target)], rules=[rule_id],
                   baseline=None)


def _rows(findings):
    return [(f.rule, f.file, f.line, f.key, f.message, f.symbol)
            for f in findings]


# ---------------------------------------------------------------------------
# parity with the reference on the same inputs
# ---------------------------------------------------------------------------

RA201_INPUTS = [os.path.join(REF_FIXTURES, n) for n in (
    "cachekey_bad.py", "cachekey_good.py", "cachekey_spec_bad.py",
    "cachekey_paged_spec_bad.py", "layering_bad", "layering_good")] + [
    SRC_REPRO, SRC_TORCH, os.path.join(FIXTURES, "cachekey_bad.py")]


@pytest.mark.parametrize("target", RA201_INPUTS,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_ra201_findings_equal_reference(target):
    want = ref.analyze([target], rules=["RA201"], baseline=None)
    got = analyze([target], rules=["RA201"], baseline=None)
    assert _rows(got.findings) == _rows(want.findings)
    assert got.files == want.files and got.errors == want.errors
    assert [f.ident for f in got.findings] == [f.ident
                                               for f in want.findings]


@pytest.mark.parametrize("target", [SRC_REPRO, SRC_TORCH, REF_FIXTURES,
                                    FIXTURES],
                         ids=["repro", "repro_torch", "ref-fixtures",
                              "fixtures"])
def test_engine_and_graph_equal_reference(target):
    """The same modules (display path, dotted name), the same import
    edges and the same re-export table."""
    want, got = ref.load_tree([target]), load_tree([target])
    assert [(m.rel, m.modname) for m in got] == [(m.rel, m.modname)
                                                for m in want]
    g_ref, g = RefImportGraph(want), ImportGraph(got)
    assert {k: [tuple(vars(e).values()) for e in v]
            for k, v in g.edges.items()} == {
        k: [tuple(vars(e).values()) for e in v]
        for k, v in g_ref.edges.items()}
    assert g.reexports == g_ref.reexports
    for key in g.reexports:
        assert g.resolve(*key) == g_ref.resolve(*key)


def test_parse_errors_and_report_shape_equal_reference(tmp_path):
    (tmp_path / "broken.py").write_text("def f(:\n    pass\n")
    (tmp_path / "fine.py").write_text("x = 1\n")
    missing = str(tmp_path / "nothing.txt")
    want = ref.analyze([str(tmp_path), missing], baseline=None)
    got = analyze([str(tmp_path), missing], baseline=None)
    assert _rows(got.findings) == _rows(want.findings)
    assert [f.rule for f in got.findings] == ["PARSE", "PARSE"]
    j_ref, j = want.to_json(), got.to_json()
    assert list(j) == list(j_ref) == ["tool", "ok", "counts", "rules",
                                      "findings", "baselined", "errors"]
    assert j["tool"] == "repro_torch.analysis"
    assert j["counts"] == j_ref["counts"]
    assert j["findings"] == j_ref["findings"]


def test_baseline_equal_reference(tmp_path):
    """One baseline file (a live entry, a stale one, an unjustified one)
    splits the same findings the same way with the same errors."""
    target = os.path.join(REF_FIXTURES, "cachekey_bad.py")
    found = analyze([target], rules=["RA201"], baseline=None).findings
    base = tmp_path / "baseline.json"
    base.write_text(json.dumps({"version": 1, "suppressions": [
        {"ident": found[0].ident, "justification": "fixture: kept on purpose"},
        {"ident": "RA201:gone.py:thing", "justification": "code moved away"},
        {"ident": "RA201:other", "justification": " "},
    ]}))
    want = ref.analyze([target], rules=["RA201"], baseline=str(base))
    got = analyze([target], rules=["RA201"], baseline=str(base))
    assert _rows(got.findings) == _rows(want.findings)
    assert _rows(got.baselined) == _rows(want.baselined)
    assert got.errors == want.errors and len(got.errors) == 2
    for bad in ({"version": 2}, [1, 2], {"version": 1, "suppressions": 3},
                {"version": 1, "suppressions": [{"justification": "x"}]}):
        base.write_text(json.dumps(bad))
        assert Baseline.load(base).load_errors == \
            ref.Baseline.load(base).load_errors != []


HOT_INPUTS = [os.path.join(REF_FIXTURES, "hotpath_bad.py"),
              os.path.join(REF_FIXTURES, "hotpath_good.py"),
              os.path.join(FIXTURES, "hotpath_bad.py"),
              os.path.join(FIXTURES, "hotpath_good.py"),
              os.path.join(SRC_REPRO, "serve"),
              os.path.join(SRC_TORCH, "serve")]


@pytest.mark.parametrize("target", HOT_INPUTS,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_hot_scopes_equal_reference(target):
    """RA401's scope discovery is the reference's: the same functions,
    for the same reason, on every module."""
    rule = ref_hotpath.HotPathPurityRule()
    want = [(m.rel, fn.name, fn.lineno, why) for m in ref.load_tree([target])
            for fn, why in rule._hot_scopes(m)]
    got = [(m.rel, fn.name, fn.lineno, why) for m in load_tree([target])
           for fn, why in hotpath.hot_scopes(m)]
    assert got == want
    if "bad" in target or target.endswith("serve"):
        assert got


def test_port_hot_scopes_cover_the_serving_loop():
    """On the port's own serve tree: every policy method, the scheduler's
    boundary methods and the async server's worker loop, with
    ``torch.cuda.set_device`` in ``_worker`` and not flagged."""
    mods = {m.rel.rsplit("/", 1)[-1]: m
            for m in load_tree([os.path.join(SRC_TORCH, "serve")])}
    hot = {f"{m}:{fn.name}" for m, mod in mods.items()
           for fn, _ in hotpath.hot_scopes(mod)}
    assert {"scheduler.py:_admit", "scheduler.py:cancel",
            "server.py:_worker", "server.py:_drain_intake",
            "policy.py:select"} <= hot
    worker = next(fn for fn, _ in hotpath.hot_scopes(mods["server.py"])
                  if fn.name == "_worker")
    assert "torch.cuda.set_device" in mods["server.py"].source
    calls = [n for n in ast.walk(worker) if isinstance(n, ast.Call)]
    assert any(call_name(c) == "torch.cuda.set_device"
               for c in calls)
    assert all(hotpath.banned_call(c) is None for c in calls)


def test_thin_clients_equal_reference():
    """Over both source trees the port selects the reference's thin
    clients (its list drops only ``benchmarks/``, which the port lacks),
    and in the port exactly its four."""
    for root in (SRC_REPRO, SRC_TORCH):
        for m in load_tree([root]):
            want = any(m.rel.endswith(s) for s in ref_layering.THIN_CLIENTS)
            assert layering.is_thin_client(m.rel) == want, m.rel
    thin = sorted(m.rel for m in load_tree([SRC_TORCH])
                  if layering.is_thin_client(m.rel))
    assert thin == [f"src/repro_torch/{p}" for p in (
        "launch/dryrun.py", "launch/serve.py", "launch/train.py",
        "serve/batcher.py")]


def test_laundered_reexport_resolves_as_reference():
    """The twin shims resolve to the defining module as the reference's
    graph resolves its own, and RA501 names the route."""
    ref_tree = ref.load_tree([os.path.join(REF_FIXTURES, "layering_bad")])
    tree = load_tree([os.path.join(FIXTURES, "layering_bad")])
    assert RefImportGraph(ref_tree).resolve("wrappers", "mode_rules") == (
        "repro.dist.sharding", "rules_for_mode")
    assert ImportGraph(tree).resolve("wrappers", "mode_rules") == (
        "repro_torch.dist.sharding", "rules_for_mode")
    assert ImportGraph(ref_tree).resolve("wrappers", "mode_rules") == (
        "repro.dist.sharding", "rules_for_mode")
    report = run_rule("RA501", "layering_bad")
    laundered = [f for f in report.findings
                 if "imported via wrappers" in f.message]
    assert laundered and "rules_for_mode" in laundered[0].message
    assert laundered[0].key == ("import:repro_torch.dist.sharding:"
                                "rules_for_mode")


# ---------------------------------------------------------------------------
# every rule flags its bad fixture and passes its good twin
# ---------------------------------------------------------------------------


def test_every_registered_rule_has_a_fixture():
    assert {r.id for r in ALL_RULES} == set(RULE_FIXTURES)


@pytest.mark.parametrize("rule_id", sorted(RULE_FIXTURES))
def test_bad_fixture_turns_red(rule_id):
    bad, _ = RULE_FIXTURES[rule_id]
    report = run_rule(rule_id, bad)
    assert report.findings, f"{bad} must produce {rule_id} findings"
    assert {f.rule for f in report.findings} == {rule_id}
    assert all(f.line > 0 and f.file for f in report.findings)
    assert not report.ok


@pytest.mark.parametrize("rule_id", sorted(RULE_FIXTURES))
def test_good_twin_is_clean(rule_id):
    _, good = RULE_FIXTURES[rule_id]
    report = run_rule(rule_id, good)
    assert not report.findings, "\n".join(
        f.render() for f in report.findings)
    assert report.ok


def test_hotpath_flags_each_torch_sync_transfer_and_allocation():
    shown = {f.key.rsplit(":", 1)[-1]
             for f in run_rule("RA401", "hotpath_bad.py").findings}
    assert shown == {"torch.cuda.synchronize", ".item", "torch.zeros",
                     ".synchronize", ".tolist", "time.sleep", "np.asarray",
                     ".numpy", '.to("cpu")', ".cpu"}


def test_layering_flags_torch_compile_capture_and_mesh_calls():
    keys = {f.key.split(":")[1] for f in run_rule("RA501",
                                                  "layering_bad").findings
            if f.key.startswith("call:")}
    assert {"init_device_mesh", "torch.compile", "torch.cuda.CUDAGraph",
            "make_serve_step", "specs_to_placements"} <= keys


def test_cachekey_flags_unkeyed_mesh_and_unknown_field():
    messages = " | ".join(f.message for f in run_rule(
        "RA201", "cachekey_bad.py").findings)
    assert "`mesh`" in messages and "no field `device`" in messages


@pytest.mark.parametrize("rule_id", sorted(NOT_APPLICABLE))
def test_not_applicable_rules_are_refused(rule_id):
    with pytest.raises(KeyError, match="does not apply to the port"):
        get_rules([rule_id])


# ---------------------------------------------------------------------------
# RA201 on the port's real plan
# ---------------------------------------------------------------------------


def test_cachekey_rule_catches_synthetic_kwarg_in_port_plan(tmp_path):
    """Inject ``fusion_mode`` into the port's
    ``ExecutionPlan.serve_executable``: consumed by the masked_decode
    builder, never passed to ``_key``. The rule must fail; the unpatched
    pair stays clean."""
    plan_src = open(os.path.join(SRC_TORCH, "plan", "plan.py")).read()
    patched = plan_src.replace(
        "def serve_executable(self, kind: str, *, batch: int, "
        "max_len: int,",
        "def serve_executable(self, kind: str, *, batch: int, "
        "max_len: int,\n                         fusion_mode: int = 0,")
    patched = patched.replace(
        "steps_per_dispatch=steps_per_dispatch, paged=paged, spec=spec)",
        "steps_per_dispatch=steps_per_dispatch + fusion_mode, "
        "paged=paged, spec=spec)")
    assert patched.count("fusion_mode") == 2, "update the patch anchors"
    cache_src = open(os.path.join(SRC_TORCH, "serve", "cache.py")).read()
    for name, src in (("patched", patched), ("clean", plan_src)):
        (tmp_path / name).mkdir()
        (tmp_path / name / "plan.py").write_text(src)
        (tmp_path / name / "cache.py").write_text(cache_src)

    report = analyze([str(tmp_path / "patched")], rules=["RA201"],
                     baseline=None)
    hits = [f for f in report.findings if "fusion_mode" in f.message]
    assert hits and hits[0].key.startswith(
        "unkeyed-param:ExecutionPlan.serve_executable")
    assert analyze([str(tmp_path / "clean")], rules=["RA201"],
                   baseline=None).ok


# ---------------------------------------------------------------------------
# the shipped tree and its baseline
# ---------------------------------------------------------------------------


def test_shipped_tree_has_no_unbaselined_findings():
    report = analyze([SRC_TORCH], baseline=BASELINE)
    assert not report.findings, "\n".join(
        f.render() for f in report.findings)
    assert not report.errors, "\n".join(report.errors)
    assert report.files > 90, "scan root looks wrong"
    assert [f.ident for f in report.baselined] == [
        "RA501:src/repro_torch/launch/dryrun.py:import:"
        "repro_torch.launch.mesh:placeholder_world"]


def test_port_baseline_entries_all_justified():
    base = Baseline.load(BASELINE)
    assert not base.load_errors, "\n".join(base.load_errors)
    assert base.entries, "the dry run's placeholder world is baselined"
    for entry in base.entries:
        assert entry["ident"].startswith(
            "RA501:src/repro_torch/launch/dryrun.py:"), entry["ident"]
        assert len(entry["justification"].strip()) >= 10
        assert "counterpart" in entry["justification"]


BAD_SNIPPET = '''
import torch


class AdmissionPolicy:
    def select(self, pending, fits, now):
        torch.cuda.synchronize()
        return pending
'''


def test_baseline_round_trip(tmp_path):
    mod = tmp_path / "policy.py"
    mod.write_text(BAD_SNIPPET)
    base = tmp_path / "baseline.json"

    red = analyze([str(mod)], baseline=None)
    assert len(red.findings) == 1 and red.findings[0].rule == "RA401"

    write_baseline(base, red.findings, "fixture: sync sanctioned here")
    green = analyze([str(mod)], baseline=base)
    assert green.ok and len(green.baselined) == 1

    base.unlink()
    red_again = analyze([str(mod)], baseline=base)  # missing file = empty
    assert not red_again.ok and len(red_again.findings) == 1

    # idents are line-number free: shifting the code keeps the baseline
    write_baseline(base, red.findings, "fixture: sync sanctioned here")
    mod.write_text("# a new leading comment line\n" + BAD_SNIPPET)
    shifted = analyze([str(mod)], baseline=base)
    assert shifted.ok and len(shifted.baselined) == 1


def test_baseline_hygiene_errors(tmp_path):
    mod = tmp_path / "policy.py"
    mod.write_text(BAD_SNIPPET)

    unjustified = tmp_path / "unjustified.json"
    unjustified.write_text(json.dumps({
        "version": 1,
        "suppressions": [{"ident": "RA401:whatever", "justification": ""}],
    }))
    report = analyze([str(mod)], baseline=unjustified)
    assert any("no justification" in e for e in report.errors)

    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps({
        "version": 1,
        "suppressions": [{"ident": "RA401:nonexistent:thing",
                          "justification": "was real once, code moved"}],
    }))
    report = analyze([str(mod)], baseline=stale)
    assert any("stale suppression" in e for e in report.errors)
    assert not report.ok, "a stale baseline must fail, not pass"


# ---------------------------------------------------------------------------
# the CLI, and what it imports
# ---------------------------------------------------------------------------


def _run_cli(args):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=60)


def test_cli_red_on_fixture_and_json_report(tmp_path):
    out = tmp_path / "report.json"
    proc = _run_cli([os.path.join(FIXTURES, "hotpath_bad.py"),
                     "--no-baseline", "--json", str(out)])
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert re.search(r"hotpath_bad\.py:\d+: RA401", proc.stdout)
    data = json.loads(out.read_text())
    assert data["tool"] == "repro_torch.analysis"
    assert not data["ok"] and data["counts"]["findings"] == 10
    for f in data["findings"]:
        assert set(f) >= {"rule", "file", "line", "message"}


def test_cli_green_on_shipped_tree():
    proc = _run_cli(["--json", "-"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    data, end = json.JSONDecoder().raw_decode(proc.stdout)
    assert data["ok"] and data["counts"]["baselined"] == 1
    assert [r["id"] for r in data["rules"]] == ["RA201", "RA401", "RA501"]
    assert re.fullmatch(
        r"repro_torch\.analysis: OK \(\d+ files, 3 rule\(s\), 1 baselined\)",
        proc.stdout[end:].strip())


def test_cli_rule_filter_and_list():
    proc = _run_cli(["--list-rules"])
    assert proc.returncode == 0
    for rid in ("RA201", "RA401", "RA501", "RA101", "RA301"):
        assert rid in proc.stdout
    assert proc.stdout.count("not applicable") == 2
    proc = _run_cli([os.path.join(FIXTURES, "hotpath_bad.py"),
                     "--no-baseline", "--rules", "RA501"])
    assert proc.returncode == 0, "RA501 alone must not flag hotpath_bad"


@pytest.mark.parametrize("rule_id", ["RA101", "RA301"])
def test_cli_refuses_rules_that_do_not_apply(rule_id):
    proc = _run_cli(["--rules", rule_id])
    assert proc.returncode == 2
    assert f"{rule_id} ({NOT_APPLICABLE[rule_id][0]}) does not apply to " \
           f"the port" in proc.stderr
    assert "traces nothing" in proc.stderr or "donates no" in proc.stderr


def test_import_and_cli_load_no_accelerator_stack(tmp_path):
    code = (
        "import sys\n"
        "import repro_torch.analysis\n"
        "from repro_torch.analysis.__main__ import main\n"
        f"rc = main(['--json', {str(tmp_path / 'r.json')!r}])\n"
        "heavy = sorted(m for m in sys.modules\n"
        "               if m.split('.')[0] in ('torch', 'numpy', 'jax',\n"
        "                                      'jaxlib', 'repro'))\n"
        "print('RC', rc, 'HEAVY', heavy)\n")
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "RC 0 HEAVY []" in proc.stdout, proc.stdout
    assert json.loads((tmp_path / "r.json").read_text())["ok"]


# ---------------------------------------------------------------------------
# the repairs: thin clients, and the train step's key
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_ra501():
    return analyze([SRC_TORCH], rules=["RA501"], baseline=None).findings


@pytest.mark.parametrize("client,name,banned", [
    ("launch/train.py", "train_inputs", "repro_torch.launch.steps"),
    ("serve/batcher.py", "serving", "repro_torch.dist.sharding"),
    ("launch/dryrun.py", "shard_act", "repro_torch.dist.sharding"),
])
def test_thin_client_no_longer_reaches_banned_module(port_ra501, client,
                                                     name, banned):
    """No RA501 finding is left in the client but the dry run's baselined
    placeholder world, and its source names the plan's route instead."""
    rel = f"src/repro_torch/{client}"
    left = [f for f in port_ra501 if f.file == rel]
    assert all(f.key == "import:repro_torch.launch.mesh:placeholder_world"
               for f in left), [f.render() for f in left]
    source = open(os.path.join(SRC_TORCH, client)).read()
    assert f"import {name}" not in source and banned not in source
    route = {"launch/train.py": "from repro_torch.models.base import",
             "serve/batcher.py": "self.plan.serving_grad_mode()",
             "launch/dryrun.py": "plan.place_batch("}[client]
    assert route in source


def test_moved_routes_behave_as_before():
    """``train_inputs`` is one function wherever it is imported from; the
    plan's serving grad mode is inference mode on one device and no_grad
    inside a sharding context; ``place_batch`` lays a batch out over the
    data axes only inside one."""
    import torch

    from repro_torch.configs import reduced_config
    from repro_torch.launch import steps
    from repro_torch.models.base import ShapeSpec, train_inputs
    from repro_torch.plan import build_plan

    assert steps.train_inputs is train_inputs
    cfg = reduced_config("yi_6b").with_(vocab=64, n_layers=2)
    assert train_inputs(cfg, ShapeSpec("t", 16, 4, "train")) == {
        "tokens": (4, 16), "labels": (4, 16)}
    plan = build_plan(cfg, ShapeSpec("t", 16, 4, "train"), device="cpu")
    with plan.serving_grad_mode():
        assert torch.is_inference_mode_enabled()
    x = torch.zeros(4, 16, dtype=torch.int32)
    assert plan.place_batch({"tokens": x})["tokens"] is x
    with plan.activate():
        with plan.serving_grad_mode():
            assert not torch.is_inference_mode_enabled()
            assert not torch.is_grad_enabled()
        placed = plan.place_batch({"tokens": x})["tokens"]
        assert type(placed).__name__ == "DTensor"
        assert torch.equal(placed.full_tensor(), x)


def test_train_step_key_follows_shard_model():
    """On a world-1 1x1 gloo mesh plan: a train step built before
    ``shard_model`` is not served after it (it was, and its unsharded step
    then failed on the DTensor parameters), the step built after it runs
    on the mesh, and ``unshard_model`` gets the first step back from the
    cache."""
    import torch

    from repro_torch.configs import reduced_config
    from repro_torch.data import make_train_iterator
    from repro_torch.models.base import ShapeSpec
    from repro_torch.plan import build_plan

    cfg = reduced_config("yi_6b").with_(vocab=64, n_layers=2)
    plan = build_plan(cfg, ShapeSpec("t", 16, 4, "train"), device="cpu")
    model, _ = plan.init_train_state(seed=0)
    plain = plan.executable("train")
    assert not plain.key.on_mesh
    plan.shard_model()
    placed = plan.executable("train")
    assert placed is not plain and placed.key.on_mesh
    assert plan.cache.stats()["builds"] == 2
    assert plan.executable("train") is placed
    batch = {k: torch.from_numpy(v) for k, v in
             next(make_train_iterator(64, 16, 4, seed=7)).items()}
    metrics = placed.fn(model, plan.placed_opt_state(model), batch)
    assert type(metrics["loss"]).__name__ == "DTensor"
    assert torch.isfinite(metrics["loss"].full_tensor())
    plan.unshard_model()
    assert plan.executable("train") is plain
    # serve steps bind no mesh: their keys do not move with the placement
    assert not plan._key("decode", 4, 16).on_mesh
    stats = plan.cache.stats()
    assert (stats["builds"], stats["hits"]) == (2, 2)
