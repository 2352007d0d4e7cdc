"""The port's lint (``pinot_tpu_torch/tools/lint``) against the JAX
package's (``pinot_tpu/tools/lint``), one counterpart for each of
``tests/test_lint.py``'s tests.

- For the families the port shares unchanged (lock discipline, pairing,
  wire, config, conservation, decisions, exactness, configkeys, threads,
  the CLI and the cache), each JAX test runs as it is with the port's lint
  in place of JAX's: every fixture goes through BOTH lints, which must
  give the same findings (family, line, key), and the JAX test's own
  assertions then hold the port's.
- The retargeted families (decline, protocol, sync, tracer, device) get
  fixtures in the port's idiom: a seeded violation that is caught and a
  clean twin that is not.
- The idioms the port's lint was taught each get a fixture proving that a
  real violation written in that idiom is still caught.
- The whole port runs once (module-scoped) with the empty baseline, under
  a wall-clock budget like JAX's.
"""

import inspect
import json
import os
import textwrap
import threading
import time

import pytest

import pinot_tpu.tools.lint.core as jcore
import tests.test_lint as J
from pinot_tpu.tools.lint import run_lint as jax_run_lint
from pinot_tpu_torch.tools.lint import run_lint
from pinot_tpu_torch.tools.lint.__main__ import main as lint_main
from pinot_tpu_torch.tools.lint.core import (
    DEFAULT_BASELINE,
    checker_names,
    load_modules,
)

PKG = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir,
    "pinot_tpu_torch"))


def _view(findings):
    return [(f.checker, f.line, f.key) for f in findings]


def _both(paths, **kw):
    """Both lints over ``paths``: equal findings, the port's returned."""
    jnew, jacc = jax_run_lint(paths, **kw)
    tnew, tacc = run_lint(paths, **kw)
    assert _view(tnew) == _view(jnew)
    assert _view(tacc) == _view(jacc)
    return tnew, tacc


def _lint(tmp_path, source, name="fixture.py", families=None):
    p = tmp_path / name
    p.write_text(textwrap.dedent(source))
    new, _ = run_lint([str(p)], families=families)
    return new


def _by(findings, checker):
    return [f for f in findings if f.checker == checker]


# --------------------------------------------------------------------------
# the shared families: JAX's own tests, both lints on every fixture
# --------------------------------------------------------------------------

SHARED = [
    "test_lock_guard_catches_unguarded_access",
    "test_lock_guard_regression_stage_get_then_set",
    "test_lock_guard_writes_only_mode_and_closures",
    "test_lock_guard_inherited_lock_and_locked_suffix",
    "test_lock_order_catches_inversion",
    "test_lock_order_follows_calls",
    "test_pairing_catches_unpaired_lease",
    "test_pairing_catches_missing_and_discarded_release",
    "test_pairing_catches_unreleased_lease_on_reject",
    "test_pairing_accepts_admission_gate_shape",
    "test_pairing_accepts_finally_and_context_manager",
    "test_pairing_catches_unpaired_segment_acquire",
    "test_wire_catches_stat_missing_from_wire",
    "test_wire_catches_launch_key_merge_disagreement",
    "test_wire_colkind_partial_dispatch_flagged",
    "test_wire_colkind_full_dispatch_clean",
    "test_config_catches_undeclared_key",
    "test_conservation_catches_unreleased_pop",
    "test_conservation_release_on_exception_edge",
    "test_conservation_catches_unaccounted_insert",
    "test_conservation_cache_parity_star_tree_nodes",
    "test_conservation_chunkacct_store_must_reach_counter",
    "test_conservation_chunkacct_no_accounting_method_at_all",
    "test_conservation_idxacct_pin_must_reach_accounting",
    "test_conservation_catches_discarded_pop",
    "test_conservation_host_tier_demote_without_account",
    "test_conservation_host_tier_pop_must_account",
    "test_conservation_spanpair_open_without_close",
    "test_conservation_spanpair_exception_edge",
    "test_cli_json_output",
    "test_cli_families_filter",
    "test_decisions_dropped_record_on_return_path",
    "test_decisions_dropped_record_on_exception_edge",
    "test_decisions_discharges_are_clean",
    "test_decisions_all_mode_checks_every_exit",
    "test_decisions_unregistered_reason_literal",
    "test_exactness_raw_wide_literal",
    "test_exactness_power_form_also_banned",
    "test_exactness_dtype_mismatched_guard",
    "test_exactness_guard_deletion_is_a_finding",
    "test_exactness_real_guard_shape_is_clean",
    "test_configkeys_undeclared_inline_key",
    "test_configkeys_declared_keys_resolve_clean",
    "test_configkeys_declared_but_unread_key",
    "test_cli_sarif_output",
    "test_inline_ignore_suppresses_with_reason",
    "test_baseline_suppresses_by_stable_key",
    "test_threads_unguarded_cross_role_write",
    "test_threads_role_widened_by_new_submit_site",
    "test_threads_post_spawn_write_to_immutable_field",
    "test_threads_stale_race_ok_on_guarded_field",
    "test_threads_race_ok_reason_must_be_registered",
    "test_threads_spawn_graph_rules",
    "test_threads_changed_scope_sees_package_spawn_graph",
    # the protocol family finds its anchors by shape, not by module name
    "test_protocol_catches_missing_take",
    "test_protocol_catches_extra_take",
    "test_protocol_raise_declines_an_op",
    "test_protocol_catches_reordered_group_takes",
    "test_protocol_pack_side_drift",
]


@pytest.mark.parametrize("name", SHARED)
def test_shared_family_fixture(name, request, monkeypatch):
    """The JAX test ``name`` with the port's lint: both lints give the
    same findings on each of its fixtures, and its assertions hold."""
    def both_lint(tmp_path, source, name="fixture.py"):
        p = tmp_path / name
        p.write_text(textwrap.dedent(source))
        return _both([str(p)])[0]

    def both_run(paths, **kw):
        return _both(paths, **kw)

    def both_main(argv=None):
        return lint_main(argv)

    monkeypatch.setattr(J, "_lint", both_lint)
    monkeypatch.setattr(J, "run_lint", both_run)
    monkeypatch.setattr(J, "lint_main", both_main)
    fn = getattr(J, name)
    kwargs = {p: request.getfixturevalue(p)
              for p in inspect.signature(fn).parameters}
    fn(**kwargs)


# --------------------------------------------------------------------------
# the whole port, once: the gate, the budget, the package-level families
# --------------------------------------------------------------------------

# JAX's ceiling for its own package (tests/test_lint.py
# test_whole_package_wall_clock_budget)
WALL_CLOCK_BUDGET_S = 120


@pytest.fixture(scope="module")
def package_run():
    """One run of every family over ``pinot_tpu_torch`` with the
    checked-in (empty) baseline: (new, accepted, new without the
    baseline, seconds)."""
    t0 = time.perf_counter()
    new, accepted = run_lint([PKG], baseline=DEFAULT_BASELINE)
    elapsed = time.perf_counter() - t0
    # inline waivers suppress with or without a baseline, and the
    # baseline is empty (test_baseline_is_empty): the run without one is
    # this run
    with open(DEFAULT_BASELINE, encoding="utf-8") as f:
        assert json.load(f)["entries"] == []
    return new, accepted, new, elapsed


def test_package_is_clean(package_run):
    """The port passes every family against the empty baseline, and with
    no baseline at all: what the families would flag is fixed in the
    code or waived inline with a registered reason."""
    new, _accepted, raw, _t = package_run
    assert not new, "\n".join(f.render() for f in new)
    assert not raw, "\n".join(f.render() for f in raw)


def test_whole_package_wall_clock_budget(package_run):
    assert package_run[3] < WALL_CLOCK_BUDGET_S, package_run[3]


def test_inline_waivers_are_registered(package_run):
    """Every waiver the port carries is inline: a ``# lint: ignore[...]``
    on the flagged line with the family named, or a ``# race-ok:`` code
    of the port's registered ``race_ok`` namespace."""
    from pinot_tpu_torch.common.tracing import RACE_OK_REASONS, \
        reason_registry

    _new, accepted, _raw, _t = package_run
    ctx, _ = load_modules([PKG])
    for f in accepted:
        m = ctx.module_of(f.path)
        assert m is not None and m.ignored(f.line, f.checker), f.render()
    ns = reason_registry("race_ok")
    found, bad = ns.conformance()
    assert not bad and found == set(RACE_OK_REASONS)


def test_threads_real_modules_stay_clean(package_run):
    assert not [f for f in package_run[2] if f.checker == "threads"]


def test_baseline_is_empty():
    with open(DEFAULT_BASELINE, encoding="utf-8") as f:
        assert json.load(f)["entries"] == []


def test_cli_exit_codes(tmp_path):
    """Exit 0 on a clean tree, 1 on a finding, 2 on an unknown family; the
    default path is the port's package."""
    assert lint_main([PKG, "--families", "wire,config,exactness"]) == 0
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent("""\
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()
                self._d = {}  # guarded-by: _lock

            def peek(self):
                return self._d.get("k")
        """))
    assert lint_main([str(bad)]) == 1
    assert lint_main([str(bad), "--families", "nonsense"]) == 2
    assert lint_main(["--list-families"]) == 0
    assert set(checker_names()) == set(jcore.checker_names())


def test_lint_imports_neither_torch_nor_the_jax_package():
    """Stdlib only: the lint runs in a process where torch cannot be
    imported, and reads nothing of ``pinot_tpu``."""
    import subprocess
    import sys

    code = ("import sys; sys.modules['torch'] = None; "
            "sys.modules['numpy'] = None; sys.modules['pinot_tpu'] = None; "
            "from pinot_tpu_torch.tools.lint.__main__ import main; "
            "sys.exit(main(['--families', 'wire']))")
    root = os.path.dirname(PKG)
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _git(cwd, *args):
    import subprocess

    subprocess.run(["git", *args], cwd=cwd, check=True,
                   capture_output=True,
                   env={**os.environ, "GIT_AUTHOR_NAME": "t",
                        "GIT_AUTHOR_EMAIL": "t@t", "GIT_COMMITTER_NAME": "t",
                        "GIT_COMMITTER_EMAIL": "t@t"})


def test_changed_selects_reverse_and_forward_deps(tmp_path):
    from pinot_tpu_torch.tools.lint.core import select_changed

    pkg = tmp_path / "mypkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "base.py").write_text("X = 1\n")
    (pkg / "mid.py").write_text("from mypkg.base import X\nY = X\n")
    (pkg / "top.py").write_text("from mypkg import mid\nZ = mid.Y\n")
    (pkg / "island.py").write_text("W = 9\n")
    _git(tmp_path, "init", "-q")
    _git(tmp_path, "add", ".")
    _git(tmp_path, "commit", "-qm", "seed")
    (pkg / "mid.py").write_text("from mypkg.base import X\nY = X + 1\n")
    got = {os.path.basename(p) for p in select_changed("HEAD", str(pkg))}
    assert got == {"mid.py", "top.py", "base.py", "__init__.py"}
    _git(tmp_path, "add", ".")
    _git(tmp_path, "commit", "-qm", "mid")
    assert select_changed("HEAD", str(pkg)) == []


def test_changed_cli_on_this_repo():
    assert lint_main(["--changed", "HEAD"]) == 0


def test_module_cache_reuses_parses(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("X = 1\n")
    ctx1, _ = load_modules([str(p)])
    ctx2, _ = load_modules([str(p)])
    assert ctx1.modules[0] is ctx2.modules[0]
    p.write_text("X = 2\n")
    ctx3, _ = load_modules([str(p)])
    assert ctx3.modules[0] is not ctx2.modules[0]


def test_cfg_memo_returns_identical_graphs():
    import ast

    from pinot_tpu_torch.tools.lint.dataflow import build_cfg

    fn = ast.parse(
        "def f(x):\n    if x:\n        return 1\n    return 0\n").body[0]
    assert build_cfg(fn) is build_cfg(fn)


# --------------------------------------------------------------------------
# configkeys: the port's own README table
# --------------------------------------------------------------------------

def _configkeys_tree(tmp_path, config_src, reader_src, readme):
    pkg = tmp_path / "pkg"
    (pkg / "spi").mkdir(parents=True)
    (pkg / "spi" / "config.py").write_text(textwrap.dedent(config_src))
    (pkg / "reader.py").write_text(textwrap.dedent(reader_src))
    (tmp_path / "README.md").write_text(textwrap.dedent(readme))
    new, _ = run_lint([str(pkg)], families=["configkeys"])
    return new


_CK_CONFIG = """\
    class CommonConstants:
        RUNNER_THREADS_KEY = "pinot.server.query.runner.threads"
        DEFAULT_RUNNER_THREADS = 8
    """
_CK_READER = """\
    from pkg.spi.config import CommonConstants

    def setup(cfg):
        return cfg.get_int(CommonConstants.RUNNER_THREADS_KEY, 8)
    """


@pytest.mark.parametrize("marker,default,want", [
    ("torch-config-keys", "4", "readme:stale:RUNNER_THREADS_KEY"),
    ("torch-config-keys", "8", None),
    # the JAX package's table is not the port's
    ("config-keys", "8", "readme:table_missing"),
])
def test_configkeys_readme_table(tmp_path, marker, default, want):
    new = _configkeys_tree(tmp_path, _CK_CONFIG, _CK_READER, f"""\
        # fixture

        <!-- {marker}:begin -->
        | key | default | controls |
        |---|---|---|
        | `pinot.server.query.runner.threads` | `{default}` | runner pool |
        <!-- {marker}:end -->
        """)
    if want is None:
        assert not new, [f.render() for f in new]
    else:
        assert len(new) == 1 and want in new[0].symbol, \
            [f.render() for f in new]


def test_configkeys_port_table_lists_port_defaults():
    """The README's port table carries the port's worker-thread default
    (1), not JAX's (min(cpu count, 8))."""
    readme = os.path.join(os.path.dirname(PKG), "README.md")
    with open(readme, encoding="utf-8") as f:
        text = f.read()
    block = text[text.index("<!-- torch-config-keys:begin -->"):
                 text.index("<!-- torch-config-keys:end -->")]
    assert "| `pinot.server.query.worker.threads` | `1` |" in block


# --------------------------------------------------------------------------
# decline: engine/fused_scan.py, codes through the port's tables
# --------------------------------------------------------------------------

@pytest.mark.parametrize("src,name,want", [
    # an _Ineligible message no classify_decline rule matches
    ("""\
        class _Ineligible(Exception):
            pass

        def extract(plan):
            raise _Ineligible("some brand new unlisted obstacle")
        """, "fused_scan.py", "classify_decline"),
    # a decline code neither DIRECT_DECLINE_CODES nor a rule holds
    ("""\
        def bind(decline):
            decline("pallas_brand_new_unregistered_code")
        """, "fused_scan.py", "DIRECT_DECLINE_CODES"),
    # registered codes, classifiable messages, dynamic arguments: clean
    ("""\
        class _Ineligible(Exception):
            pass

        def extract(plan, decline, op):
            decline("pallas_too_many_groups")
            if plan:
                raise _Ineligible("lut with too many runs")
            raise _Ineligible(op)
        """, "fused_scan.py", None),
    # only the fused scan's module is in scope (JAX's name is not)
    ("""\
        def f(decline):
            decline("not_a_pallas_code_at_all")
        """, "pallas_kernels.py", None),
])
def test_decline_codes_resolve_through_port_tables(tmp_path, src, name,
                                                   want):
    found = _by(_lint(tmp_path, src, name=name), "decline")
    if want is None:
        assert not found, [f.render() for f in found]
    else:
        assert len(found) == 1 and want in found[0].message


def _real_src(rel):
    with open(os.path.join(PKG, *rel.split("/")), encoding="utf-8") as f:
        return f.read()


def test_decline_real_fused_scan_is_clean_and_scoped(tmp_path):
    """The port's fused_scan.py resolves every literal; one seeded new
    message is the only finding."""
    src = _real_src("engine/fused_scan.py")
    p = tmp_path / "fused_scan.py"
    p.write_text(src)
    assert not _by(run_lint([str(p)], families=["decline"])[0], "decline")
    bad = src.replace('raise _Ineligible("raw group key")',
                      'raise _Ineligible("a brand new obstacle")')
    assert bad != src
    p.write_text(bad)
    found = _by(run_lint([str(p)], families=["decline"])[0], "decline")
    assert len(found) == 1, [f.render() for f in found]


# --------------------------------------------------------------------------
# protocol: a scratch copy of the port's fused_scan.py against plan.py
# --------------------------------------------------------------------------

def test_protocol_flags_reordered_take_in_fused_scan_scratch(tmp_path):
    plan_src = _real_src("engine/plan.py")
    fs_src = _real_src("engine/fused_scan.py")
    s_line = "strides = [int(s) for s in np.asarray(pc.take())]"
    b_line = "bases = [int(b) for b in np.asarray(pc.take())]"
    assert s_line in fs_src and b_line in fs_src
    swapped = (fs_src.replace(s_line, "@@SWAP@@").replace(b_line, s_line)
               .replace("@@SWAP@@", b_line))
    (tmp_path / "plan.py").write_text(plan_src)
    (tmp_path / "fused_scan.py").write_text(swapped)
    new, _ = run_lint([str(tmp_path)], families=["protocol"])
    assert [f for f in new if "group-order" in f.symbol], \
        [f.render() for f in new]
    (tmp_path / "fused_scan.py").write_text(fs_src)
    clean, _ = run_lint([str(tmp_path)], families=["protocol"])
    assert not clean, [f.render() for f in clean]


# --------------------------------------------------------------------------
# sync: tensors on the card reaching a host sync
# --------------------------------------------------------------------------

SYNC_LOCK = """\
    import threading

    import numpy as np
    import torch


    class Accum:
        def __init__(self):
            self._lock = threading.Lock()
            self.total = 0.0

        def add(self, x):
            dev = torch.sum(x)
            with self._lock:
                self.total += float(dev)

        def add_item(self, x):
            dev = x.to("cuda") * 2
            with self._lock:
                self.total += dev.sum().item()

        def add_wrapper(self, prog, packed):
            out = fused_scan(prog, packed)
            with self._lock:
                return out.tolist(), np.asarray(out), out.cpu()

        def wait(self):
            with self._lock:
                torch.cuda.synchronize()

        def add_ok(self, x):
            host = float(torch.sum(x))  # the sync before the lock
            with self._lock:
                self.total += host

        def meta_ok(self, x):
            dev = torch.sum(x)
            with self._lock:
                self.total += dev.numel() + int(dev.shape[0]) \\
                    + len(dev.dtype.__repr__()) + len(str(dev.device))

        def host_ok(self, a):
            t = torch.from_numpy(a)
            with self._lock:
                self.total += t.sum().item()
    """


def test_sync_catches_host_syncs_under_lock(tmp_path):
    found = {f.symbol for f in _by(_lint(tmp_path, SYNC_LOCK), "sync")}
    assert found == {"Accum.add:float()", "Accum.add_item:.item()",
                     "Accum.add_wrapper:.tolist()",
                     "Accum.add_wrapper:np.asarray()",
                     "Accum.add_wrapper:.cpu()",
                     "Accum.wait:torch.cuda.synchronize()"}, found


@pytest.mark.parametrize("body,bad", [
    ("dev = torch.zeros(4, device='cuda')\n        return dev.tolist()",
     True),
    ("torch.cuda.current_stream().synchronize()", True),
    ("event = torch.cuda.Event()\n        event.record()", False),
    ("return torch.zeros(4).shape[0]", False),
])
def test_sync_catches_dispatcher_thread_syncs(tmp_path, body, bad):
    src = f"""\
import threading

import torch


class Dispatcher:
    def start(self):
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self):
        {body}
"""
    p = tmp_path / "mini_launcher.py"
    p.write_text(src)
    found = _by(run_lint([str(p)], families=["sync"])[0], "sync")
    assert bool(found) == bad, [f.render() for f in found]


def test_sync_catches_gauge_callback_syncs(tmp_path):
    found = _by(_lint(tmp_path, """\
        import torch


        class Exporter:
            def __init__(self, registry):
                self._staged = torch.zeros(8, device="cuda")
                self.depth = 3
                dev = torch.sum(self._staged)
                registry.gauge("staged_total", lambda: float(dev))
                registry.gauge("queue_depth", lambda: float(self.depth))

            def bind(self, registry):
                registry.gauge("staged_sum", self._read_total)

            def _read_total(self):
                return torch.sum(self._staged).item()
        """), "sync")
    assert any("gauge-lambda:float()" in f.symbol for f in found)
    assert any("_read_total" in f.symbol for f in found)
    assert not any("queue_depth" in f.render() for f in found)


def test_sync_launcher_dispatcher_leaves_the_wait_to_riders():
    """The port's dispatcher records an event per device after a group
    and each rider waits on it: nothing on the dispatcher thread syncs."""
    new, _ = run_lint([os.path.join(PKG, "parallel")], families=["sync"])
    assert not [f for f in new if "dispatcher" in f.message], \
        [f.render() for f in new]


# --------------------------------------------------------------------------
# tracer: torch.compile / torch.jit.script / torch.cuda.graph roots
# --------------------------------------------------------------------------

def test_tracer_catches_host_effects_under_compile(tmp_path):
    tf = _by(_lint(tmp_path, """\
        import time
        import torch


        def helper(x):
            return x + time.time()


        @torch.compile
        def decorated(x):
            return helper(x)


        def kernel(x):
            return float(x) + 1.0


        def build():
            return torch.jit.script(kernel)
        """), "tracer")
    msgs = " | ".join(f.message for f in tf)
    assert "time.time" in msgs
    assert any("float" in f.symbol for f in tf)


def test_tracer_catches_item_and_global_mutation_in_capture(tmp_path):
    syms = {f.symbol for f in _by(_lint(tmp_path, """\
        import torch

        _CACHE = {}


        def kernel(x):
            _CACHE[int(x.shape[0])] = 1
            return x.sum().item()


        def capture(x):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                y = kernel(x)
                open("log")
            return g, y


        out = torch.compile(kernel)
        """), "tracer")}
    assert {"kernel:item", "kernel:mutate:_CACHE",
            "<cuda graph capture>:open"} <= syms, syms


def test_tracer_ignores_uncompiled_functions_and_the_port(tmp_path):
    """No root, no finding: a host function, and the whole port, which
    compiles and captures nothing today."""
    assert not _by(_lint(tmp_path, """\
        import time
        import torch


        def host_side(x):
            return torch.sum(x) + time.time()
        """), "tracer")
    assert not run_lint([PKG], families=["tracer"])[0]


# --------------------------------------------------------------------------
# device: the obligations with a counterpart in the port
# --------------------------------------------------------------------------

def _device_scratch(tmp_path, name, src):
    p = tmp_path / name
    p.write_text(src)
    new, _ = run_lint([str(p)], families=["device"])
    return _by(new, "device")


@pytest.mark.parametrize("rel", [
    "engine/fused_scan.py", "engine/plan.py", "engine/startree_device.py",
    "parallel/mesh.py", "parallel/combine.py", "parallel/reduce_device.py",
    "parallel/batch.py", "parallel/executor.py"])
def test_device_clean_on_real_modules(tmp_path, rel):
    hits = _device_scratch(tmp_path, os.path.basename(rel), _real_src(rel))
    assert not hits, [f.render() for f in hits]


@pytest.mark.parametrize("rel,old,new,want", [
    # pow2-narrow: the narrowed group count skips _next_pow2
    ("engine/plan.py", "    num_groups = _next_pow2(total)\n    strides",
     "    num_groups = total\n    strides", "_next_pow2"),
    # pow2-narrow: the SegmentPlan(spec=...) form drops the capacity slot
    ("engine/plan.py",
     "spec=(filter_spec, agg_specs, group_specs, num_groups, capacity)",
     "spec=(filter_spec, agg_specs, group_specs, num_groups, 4096)",
     "capacity"),
    # idxcap: the star-tree index pad sized off the spec
    ("engine/startree_device.py",
     "padded = np.zeros(plan.spec[-1], dtype=np.int32)",
     "padded = np.zeros(n, dtype=np.int32)", "capacity"),
    # smem-cap: the run cap over the config default
    ("engine/fused_scan.py", "DEFAULT_LUT_RUN_CAP = 64",
     "DEFAULT_LUT_RUN_CAP = 1024", "DEFAULT_PALLAS_LUT_MAX_RUNS"),
    # mesh-axis: a shape key the mesh never declared
    ("parallel/mesh.py",
     "self.shape = {SEG_AXIS: n_seg, DOC_AXIS: n_doc}",
     "self.shape = {SEG_AXIS: n_seg, \"docs\": n_doc}", "'docs'"),
    # mesh-axis: a fold the mesh does not define
    ("parallel/mesh.py",
     "for di in range(mesh.n_doc)], \"sum\", mesh.root)",
     "for di in range(mesh.n_doc)], \"mean\", mesh.root)", "'mean'"),
])
def test_device_seeded_mutation(tmp_path, rel, old, new, want):
    src = _real_src(rel)
    assert old in src, (rel, old)
    hits = _device_scratch(tmp_path, os.path.basename(rel),
                           src.replace(old, new))
    assert len(hits) == 1 and want in hits[0].message, \
        [f.render() for f in hits]


# the JAX family's Pallas-only obligations (tests/test_lint.py:
# test_device_swapped_blockspec_dim, ..._helper_concat_swap_..., 
# ..._i64_inside_kernel_body, ..._i64_outside_blessed_functions,
# ..._value_ref_count_drift, ..._mismatched_psum_axis,
# ..._bad_axis_through_helper_param, ..._reduce_bad_axis_...): the port
# has no BlockSpecs, Mosaic dtypes or psum axes, so its family is silent
# on JAX's Pallas builders where JAX's is not; chip_smoke.py's test of
# each kernel against its plain version does that work on the card
@pytest.mark.parametrize("rel,old,new", [
    ("engine/pallas_kernels.py", "DEFAULT_LUT_RUN_CAP = 64",
     "DEFAULT_LUT_RUN_CAP = 1024"),
    ("parallel/combine.py", "local = jax.lax.psum(local, DOC_AXIS)",
     "local = jax.lax.psum(local, \"docs\")"),
    ("engine/pallas_kernels.py",
     "for _ in range(n_value_refs):\n        "
     "in_specs.append(block((RT, 128)))",
     "for _ in range(n_values):\n        "
     "in_specs.append(block((RT, 128)))"),
])
def test_device_pallas_obligations_have_no_counterpart(tmp_path, rel, old,
                                                       new):
    jpkg = os.path.dirname(os.path.abspath(jcore.__file__))
    jpkg = os.path.normpath(os.path.join(jpkg, os.pardir, os.pardir))
    with open(os.path.join(jpkg, *rel.split("/")), encoding="utf-8") as f:
        src = f.read()
    assert old in src
    p = tmp_path / os.path.basename(rel)
    p.write_text(src.replace(old, new))
    jhits = _by(jax_run_lint([str(p)], families=["device"])[0], "device")
    thits = _by(run_lint([str(p)], families=["device"])[0], "device")
    assert jhits and not thits, [f.render() for f in thits]


# --------------------------------------------------------------------------
# the port's idioms: recognised, and a violation in each still caught
# --------------------------------------------------------------------------

HELPER_UNDER_LOCK = """\
    import threading

    class Manager:
        def __init__(self):
            self._lock = threading.Lock()
            self._fsms = {{}}  # guarded-by: _lock

        def _fsm(self, name):
            f = self._fsms.get(name)
            if f is None:
                f = self._fsms[name] = object()
            return f

        def consumed(self, name):
            with self._lock:
                return self._fsm(name)
    {extra}
    """


@pytest.mark.parametrize("extra,bad", [
    ("", False),
    # one call of the helper outside the lock: its accesses are unguarded
    ("\n        def peek(self, name):\n            return self._fsm(name)\n",
     True),
    # the helper handed out as a callback: no longer provably under it
    ("\n        def hook(self):\n            return self._fsm\n", True),
])
def test_idiom_private_helper_called_under_the_lock(tmp_path, extra, bad):
    found = _by(_lint(tmp_path, HELPER_UNDER_LOCK.format(extra=extra)),
                "lock-guard")
    assert bool(found) == bad, [f.render() for f in found]


def test_idiom_server_ensure_online_runs_under_reconcile_lock():
    """``_pushed_crc`` (server/server.py) is touched in ``_ensure_online``,
    which only ``_reconcile_table_locked`` calls: the lock is held."""
    from pinot_tpu_torch.tools.lint.locks import (
        collect_classes,
        held_helpers,
    )

    ctx, _ = load_modules([os.path.join(PKG, "server", "server.py")])
    ci = next(c for c in collect_classes(ctx)[0]
              if c.name == "ServerInstance")
    assert "_reconcile_lock" in held_helpers(ci)["_ensure_online"]
    assert ci.guarded["_pushed_crc"][0] == "_reconcile_lock"


TYPED_RECEIVERS = """\
    import threading

    class Meta:
        def column(self, name):
            return name

    class Staged:
        def __init__(self, meta: Meta):
            self._lock = threading.Lock()
            self.meta = meta

        def column(self, name):
            with self._lock:
                return {call_in_staged}

    class Batch:
        def __init__(self):
            self._lock = threading.Lock()
            self.metadata = Meta()
            self.staged = Staged(self.metadata)

        def column(self, name):
            with self._lock:
                return {call_in_batch}
    """


@pytest.mark.parametrize("in_staged,in_batch,bad", [
    # ``meta.column`` is Meta's: no lock taken, no edge, no inversion
    ("self.meta.column(name)", "self.metadata.column(name)", False),
    # a real inversion through typed receivers is still an inversion
    ("self.meta.column(name) and BATCH.column(name)",
     "self.staged.column(name)", True),
])
def test_idiom_receiver_types_resolve_calls(tmp_path, in_staged, in_batch,
                                            bad):
    src = TYPED_RECEIVERS.format(call_in_staged=in_staged,
                                 call_in_batch=in_batch)
    found = _by(_lint(tmp_path, src), "lock-order")
    assert bool(found) == bad, [f.render() for f in found]


TICKETS = """\
    def handle(gate, tables, work):
        tickets = []
        try:
            for t in tables:
                tickets.append(gate.admit(t))
        except RuntimeError:
            for tk in tickets:
                gate.release(tk)
            return None
    {tail}
    """


@pytest.mark.parametrize("tail,bad", [
    ("    try:\n            return work()\n        finally:\n"
     "            for tk in tickets:\n                gate.release(tk)\n",
     False),
    # released only on the fall-through: an exception leaks every slot
    ("    out = work()\n        for tk in tickets:\n"
     "            gate.release(tk)\n        return out\n", True),
    # never released
    ("    return work()\n", True),
])
def test_idiom_ticket_list_released_in_finally(tmp_path, tail, bad):
    found = _by(_lint(tmp_path, TICKETS.format(tail=tail)), "pairing")
    assert bool(found) == bad, [f.render() for f in found]


WIRE_TABLES = """\
    from dataclasses import InitVar, dataclass

    WIRE_COUNTERS = (("scan_launches", "scanLaunches"),
                     ("topk_launches", "topkLaunches"))
    LAUNCH_MAX_KEYS = ("batchSize",)


    def merge_launch(into, other):
        for k, v in other.items():
            into[k] = max(into.get(k, 0), v) if k in LAUNCH_MAX_KEYS \\
                else into.get(k, 0) + v


    @dataclass
    class QueryStats:
        num_docs: int = 0
        total_docs: int = 0
        scan_launches: int = 0
        topk_launches: int = 0
        launch: dict = None
        lease: InitVar[object] = None

        def __post_init__(self, lease):
            self.lease = lease

        def add_launches(self, other):
            for name, _wire in WIRE_COUNTERS:
                setattr(self, name, getattr(self, name) + getattr(other, name))

        def merge(self, other):
            for name in ({merged}):
                setattr(self, name, getattr(self, name) + getattr(other, name))
            self.add_launches(other)
            merge_launch(self.launch, other.launch)

        def to_dict(self):
            counters = {{w: getattr(self, n) for n, w in WIRE_COUNTERS}}
            return {{"numDocsScanned": self.num_docs,
                    "totalDocs": self.total_docs, "launch": self.launch,
                    **counters}}

        @classmethod
        def from_dict(cls, st):
            out = cls(num_docs=st.get("numDocsScanned", 0),
                      total_docs=st.get("totalDocs", 0),
                      launch=st.get("launch"))
            for name, wire in WIRE_COUNTERS:
                setattr(out, name, st.get(wire, 0))
            return out
    """


@pytest.mark.parametrize("merged,missing", [
    ('"num_docs", "total_docs"', None),
    # a field left out of the merged tuple is still dropped at merge
    ('"num_docs",', "QueryStats.total_docs:merge"),
])
def test_idiom_wire_name_tables(tmp_path, merged, missing):
    found = _by(_lint(tmp_path, WIRE_TABLES.format(merged=merged)), "wire")
    assert [f.symbol for f in found] == ([missing] if missing else []), \
        [f.render() for f in found]


RESIDENT = """\
    import threading

    class Staged:
        def __init__(self):
            self._lock = threading.Lock()
            self._packed = {{}}
            self._num_docs = None
            self._cursor: Dict[str, int] = {{}}
            self.h2d_bytes = 0
            self._bytes = 0

        def packed(self, name, t):
            with self._lock:
                self._packed[name] = t
                self._cursor[name] = 1
                self.h2d_bytes += 4
                self._bytes += 4

        def num_docs(self, t):
            self._num_docs = t
            {bump}

        def nbytes(self):
            return self._bytes

        def release(self):
            with self._lock:
                self._drop_locked()

        def _drop_locked(self):
            self._packed.clear()
            self._cursor.clear()
            {drop}
            self._bytes = 0
    """


@pytest.mark.parametrize("bump,drop,want", [
    ("self._bytes += 8", "self._num_docs = None", set()),
    # a tensor kept outside the running byte total
    ("pass", "self._num_docs = None",
     {"Staged._num_docs:nbytes"}),
    # a release helper that forgets one field
    ("self._bytes += 8", "pass", {"Staged._num_docs:release"}),
])
def test_idiom_running_byte_counter_and_release_helper(tmp_path, bump,
                                                       drop, want):
    found = _by(_lint(tmp_path, RESIDENT.format(bump=bump, drop=drop)),
                "conservation")
    assert {f.symbol for f in found} == want, [f.render() for f in found]


CHUNKS = """\
    class Chunks:
        def __init__(self):
            self._chunks = {{}}

        def put(self, key, t):
            self._chunks[key] = t

        def nbytes(self):
            {nbytes}

        def release(self):
            self._chunks.clear()
    """


@pytest.mark.parametrize("nbytes,bad", [
    ("return sum(t.numel() for t in self._chunks.values())", False),
    # counting entries is not measuring them
    ("return len(self._chunks)", True),
])
def test_idiom_nbytes_walks_its_chunks(tmp_path, nbytes, bad):
    found = _by(_lint(tmp_path, CHUNKS.format(nbytes=nbytes)),
                "conservation")
    assert bool(found) == bad, [f.render() for f in found]


def test_idiom_reason_tables_beside_their_modules(tmp_path):
    """A table ``common/tracing.py`` imports from its module registers
    its codes; a code in no table is still caught."""
    pkg = tmp_path / "pkg"
    (pkg / "common").mkdir(parents=True)
    (pkg / "broker").mkdir()
    (pkg / "common" / "tracing.py").write_text(textwrap.dedent("""\
        def _build_registry():
            from pkg.broker.routing import ROUTING_DECISION_REASONS
            return ROUTING_DECISION_REASONS
        """))
    (pkg / "broker" / "routing.py").write_text(textwrap.dedent("""\
        ROUTING_DECISION_REASONS = frozenset({"no_filter"})


        def _partition_prune(declined, f):
            if f is None:
                declined("no_filter")
                return None
            declined("never_registered")
            return None
        """))
    found = _by(run_lint([str(pkg)], families=["decisions"])[0],
                "decisions")
    assert len(found) == 1 and "never_registered" in found[0].message, \
        [f.render() for f in found]


THREAD_ROLES = """\
    import threading

    import numpy as np


    class Cluster:
        def __init__(self):
            self.n = 0

        def query(self):
            self.n += 1

        def array(self):
            self.n += 1


    class Copies:
        def __init__(self):
            self.cluster = Cluster()

        def start(self):
            threading.Thread(target=self._loop, name="hbm-prefetch",
                             daemon=True).start()

        def _loop(self, event, a):
            event.query()           # a CUDA event, not Cluster.query
            np.array(a)             # numpy, not Cluster.array
            {leak}
    """


@pytest.mark.parametrize("leak,bad", [
    ("pass", False),
    # the prefetcher really reaches Cluster.query: a cross-role write
    ("self.cluster.query()", True),
])
def test_idiom_torch_and_module_calls_carry_no_role(tmp_path, leak, bad):
    found = _by(_lint(tmp_path, THREAD_ROLES.format(leak=leak)), "threads")
    assert bool(found) == bad, [f.render() for f in found]


# --------------------------------------------------------------------------
# the lock-order finding: the two staging paths from two threads
# --------------------------------------------------------------------------

class _OrderedLock:
    """A lock that records, per thread, which named locks were held when
    it was taken."""

    held = threading.local()
    edges = set()
    mu = threading.Lock()

    def __init__(self, name, inner):
        self.name = name
        self.inner = inner

    def __enter__(self):
        stack = getattr(self.held, "stack", [])
        with self.mu:
            for h in stack:
                if h != self.name:
                    self.edges.add((h, self.name))
        self.inner.acquire()
        self.held.stack = stack + [self.name]
        return self

    def __exit__(self, *exc):
        self.held.stack = self.held.stack[:-1]
        self.inner.release()
        return False


def test_batch_and_segment_staging_take_no_inverted_locks():
    """``StagedBatch.packed_column`` / ``column`` (batch lock) and a
    segment's ``packed_column`` / ``column`` with the column borrower
    (segment lock) run from two threads over the same segments: neither
    lock is ever taken under the other, so no A->B / B->A pair exists
    (the JAX lint's finding came from ``metadata.column()`` resolving to
    the staged classes' ``column`` by name)."""
    import numpy as np

    from pinot_tpu_torch.engine.staging import StagedSegment
    from pinot_tpu_torch.parallel.batch import SegmentBatch, StagedBatch
    from pinot_tpu_torch.segment.creator import SegmentBuilder
    from pinot_tpu_torch.spi import FieldSpec, FieldType, DataType, Schema

    schema = Schema("t", [FieldSpec("k", DataType.STRING),
                          FieldSpec("v", DataType.LONG, FieldType.METRIC)])
    rng = np.random.default_rng(7)
    segs = [SegmentBuilder(schema, f"t_{i}").build({
        "k": np.array([f"k{j}" for j in rng.integers(0, 9, 3000)]),
        "v": rng.integers(0, 100, 3000)}) for i in range(3)]
    _OrderedLock.edges.clear()
    batch = StagedBatch(SegmentBatch(segs), device="cpu")
    batch._lock = _OrderedLock("batch", batch._lock)

    def borrow(segment, name):
        return batch.held_column(name)

    staged = []
    for s in segs:
        st = StagedSegment(s, device="cpu", borrower=borrow)
        st._lock = _OrderedLock(f"segment:{s.segment_name}", st._lock)
        staged.append(st)
    errors = []

    def batch_side():
        try:
            for _ in range(20):
                batch.packed_column("k")
                batch.column("k")
                batch.value_column("v")
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    def segment_side():
        try:
            for _ in range(20):
                for st in staged:
                    st.packed_column("k")
                    st.column("k")
                    st.value_column("v")
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=batch_side),
               threading.Thread(target=segment_side)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads), "deadlocked"
    assert not errors, errors
    inverted = {(a, b) for a, b in _OrderedLock.edges
                if (b, a) in _OrderedLock.edges}
    assert not inverted, inverted
    assert not [e for e in _OrderedLock.edges if "batch" in e
                and any(x.startswith("segment:") for x in e)], \
        _OrderedLock.edges
