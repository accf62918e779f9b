"""tdx-lint of the port (``torchdistx_tpu_torch.analysis``,
``scripts/torch_tdx_lint.py``) held against the JAX package's.

The core is a copy: on the same sources it gives the same report
(suppressions, TDX100, the baseline compare and the finding key), and each
package's validator takes the other's report.  TDX105 and TDX106 are the
JAX rules as they are, so they give the same findings on the JAX tests'
snippets.  TDX102-TDX104 say in torch what the JAX rules say in jax: each
has a positive and a negative torch snippet.  TDX101 has no torch
counterpart, which the catalog says.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from torchdistx_tpu import analysis as jan
from torchdistx_tpu_torch import analysis as tan

ROOT = Path(__file__).resolve().parent.parent
CLI = ROOT / "scripts" / "torch_tdx_lint.py"


def _lint(source, rel_path="pkg/mod.py", shared=None):
    return tan.lint_source(rel_path, textwrap.dedent(source), tan.default_rules(),
                           shared=shared)


def _rules_of(findings):
    return sorted(f.rule for f in findings)


def _shared_rules(pkg):
    """The rules both packages carry as they are: TDX105 and TDX106."""
    return [r for r in pkg.default_rules() if r.rule_id in ("TDX105", "TDX106")]


# sources over which the two cores must agree: suppressions valid, bare
# (TDX100), for the wrong rule, and inside a string; TDX105/TDX106 findings
SOURCES = {
    "pkg/metrics.py": (
        'c = reg.counter("tdx_serve_requests_total")\n'
        "c.set(3)  # tdx-lint: disable=TDX105 -- fixture: a settable counter\n"
        "c.dec()  # tdx-lint: disable=TDX105\n"
        "c.inc(-1)  # tdx-lint: disable=TDX106 -- wrong rule id\n"
        's = "# tdx-lint: disable=TDX105 -- not a comment"\n'
        'fam = MetricFamily("tdx_ghost_series_total", "doc")\n'
    ),
    "pkg/rows.py": (
        "import time\n\n"
        "def emit(ledger, names):\n"
        "    for n in set(names):\n"
        '        ledger.add(row(name=n, metric_class="counter"))\n'
        "    return time.time()\n"
    ),
    "pkg/clean.py": "x = 1\n",
}


@pytest.fixture
def tree(tmp_path):
    for rel, src in SOURCES.items():
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(src)
    return tmp_path


def test_core_report_equals_jax(tree):
    got = tan.run_lint(["pkg"], _shared_rules(tan), root=str(tree))
    want = jan.run_lint(["pkg"], _shared_rules(jan), root=str(tree))
    assert got == want
    assert got["schema"] == tan.LINT_SCHEMA == jan.LINT_SCHEMA == "tdx-lint-v1"
    assert [f["rule"] for f in got["findings"]].count("TDX100") == 1
    assert len(got["suppressions"]) == 1


def test_suppression_parsing_equals_jax():
    for rel, src in SOURCES.items():
        got = [s.to_dict() for s in tan.parse_suppressions(rel, src)]
        want = [s.to_dict() for s in jan.parse_suppressions(rel, src)]
        assert got == want


def _finding(rule="TDX102", path="a.py", line=1, **kw):
    return dict(dict(rule=rule, severity="error", path=path, line=line, col=0,
                     message="m"), **kw)


def test_baseline_compare_and_finding_key_equal_jax():
    report = {"findings": [_finding(line=1), _finding(line=2)]}
    baseline = {"findings": [_finding(line=2, message="other", col=7), _finding(line=3)]}
    assert (tan.compare_to_baseline(report, baseline)
            == jan.compare_to_baseline(report, baseline))
    assert [f["line"] for f in tan.compare_to_baseline(report, baseline)["new"]] == [1]
    assert tan.finding_key(_finding()) == jan.finding_key(_finding()) == ("TDX102", "a.py", 1)


def test_each_validator_takes_the_others_report(tree):
    torch_report = tan.run_lint(["pkg"], tan.default_rules(), root=str(tree))
    jax_report = jan.run_lint(["pkg"], jan.default_rules(), root=str(tree))
    for report in (torch_report, jax_report):
        assert tan.validate_lint_report(report) == []
        assert jan.validate_lint_report(report) == []
    bad = dict(torch_report, schema="nope", findings=[_finding(rule="X1")])
    assert tan.validate_lint_report(bad) == jan.validate_lint_report(bad) != []


# the JAX tests' TDX105 / TDX106 snippets (tests/test_static_analysis.py)
METRIC_SNIPPETS = [
    'c = registry.counter("tdx_serve_requests_total")\nc.set(3)\n',
    'c = registry.counter("tdx_serve_requests_total")\nc.inc(-1)\n',
    'c = registry.counter("tdx_serve_requests_total")\nc.inc(2)\n',
    'g = registry.gauge("tdx_serve_depth")\ng.set(3)\n',
    'fam = MetricFamily("tdx_ghost_series_total", "doc")\n',
    'fam = MetricFamily("process_cpu_seconds_total", "doc")\n',
    "c = reg.counter('tdx_q_total')\nc.dec()\n",
    "import time\n\ndef emit(ledger):\n"
    '    ledger.add(row(name="tdx_x_total", metric_class="counter"))\n'
    "    return time.time()\n",
    "def emit(ledger, names):\n    for n in set(names):\n"
    '        ledger.add(row(name=n, metric_class="counter"))\n',
    "import time\n\ndef emit(ledger):\n"
    '    ledger.add(row(name="tdx_x_ms", metric_class="timing"))\n'
    "    return time.time()\n",
    "def emit(ledger, names):\n    for n in sorted(set(names)):\n"
    '        ledger.add(row(name=n, metric_class="counter"))\n',
    "import time\n\ndef emit(led):\n    led.add(row(metric_class='counter'))\n"
    "    return time.perf_counter()\n",
]


@pytest.mark.parametrize("i", range(len(METRIC_SNIPPETS)))
def test_tdx105_and_tdx106_findings_equal_jax(i):
    src = METRIC_SNIPPETS[i]
    got, _ = tan.lint_source("pkg/m.py", src, _shared_rules(tan))
    want, _ = jan.lint_source("pkg/m.py", src, _shared_rules(jan))
    assert [f.to_dict() for f in got] == [f.to_dict() for f in want]


def test_cross_file_registration_equals_jax():
    for pkg in (tan, jan):
        shared = {}
        pkg.lint_source("pkg/c.py", 'def collect(prefix="tdx_fleet"):\n    pass\n',
                        _shared_rules(pkg), shared=shared)
        found, _ = pkg.lint_source("pkg/e.py",
                                   'fam = MetricFamily("tdx_fleet_route_depth", "doc")\n',
                                   _shared_rules(pkg), shared=shared)
        assert found == []


# -- the torch rules -----------------------------------------------------------------

POSITIVE = {
    "TDX102": [
        "import torch\ntorch.manual_seed(0)\n",
        "import torch\ntorch.cuda.manual_seed_all(0)\n",
        "import torch\nx = torch.randn(3, 4)\n",
        "import torch\np = torch.randperm(8)\n",
        "w.normal_(0.0, 0.02)\n",
        "import torch\ntorch.nn.init.trunc_normal_(w, std=0.02)\n",
        "import numpy as np\nx = np.random.randn(3)\n",
    ],
    "TDX103": [
        "import torch.distributed as dist\ndist.all_reduce(t)\n",
        "import torch.distributed as dist\ndist.all_gather_into_tensor(out, t)\n",
        "import torch\ntorch.distributed.broadcast(t, src=0)\n",
        "import torch.distributed as dist\nreq = dist.isend(t, dst=1)\n",
        # a barrier moves no payload: no booking exempts it
        "import torch.distributed as dist\n\ndef f():\n"
        "    record_collective('all_reduce', 'dp', t)\n    dist.barrier()\n",
        # booking in a sibling function does not exempt
        "import torch.distributed as dist\n\ndef book():\n"
        "    record_collective('all_reduce', 'dp', t)\n\ndef go():\n"
        "    dist.all_reduce(t)\n",
    ],
    "TDX104": [
        "import torch\nwith torch.cuda.graph(g):\n    n = int(flag.sum())\n",
        "def body():\n    return x.item()\n\nloop.capture(body)\n",
        "class E:\n    def _it(self):\n        torch.cuda.synchronize()\n\n"
        "    def go(self):\n        self.loop.run(self._it, 1, 4)\n",
        "import torch\nf = torch.cuda.make_graphed_callables(lambda x: x.cpu(), (a,))\n",
        "def body():\n    ev.synchronize()\n\nGraphLoop(cursor=c, capacity=4, done=d).run(body, 1, 2)\n",
    ],
}
NEGATIVE = {
    "TDX102": [
        "import torch\ng = torch.Generator().manual_seed(0)\nx = torch.randn(3, generator=g)\n",
        "w.normal_(0.0, 0.02, generator=g)\n",
        "import torch\ntorch.nn.init.trunc_normal_(w, std=0.02, generator=g)\n",
        "import numpy as np\nrs = np.random.RandomState(0)\nx = rs.randn(3)\n",
        "import numpy as np\nrng = np.random.default_rng(0)\n",
        "import torch\nx = torch.zeros(3).fill_(1.0)\n",
    ],
    "TDX103": [
        "from torchdistx_tpu_torch.parallel import collectives\ny = collectives.all_reduce(t, 'dp')\n",
        "import torch.distributed as dist\n\ndef f():\n"
        "    record_collective('all_reduce', 'dp', t)\n    dist.all_reduce(t)\n",
        "import torch.distributed as dist\n\ndef f():\n    _record('all_gather', 'dp', t)\n"
        "    dist.all_gather_into_tensor(out, t)\n",
        "import torch.distributed as dist\nr = dist.get_rank()\n",
    ],
    "TDX104": [
        "def body():\n    return x.item()\n\nengine.run(requests)\n",
        "import torch\nwith torch.cuda.graph(g):\n    y = x * 2\nn = y.item()\n",
        "def body():\n    return float(3)\n\nloop.capture(body)\n",
    ],
}


@pytest.mark.parametrize("rule,i", [(r, i) for r in POSITIVE for i in range(len(POSITIVE[r]))])
def test_torch_rule_flags_its_positive_snippet(rule, i):
    findings, _ = _lint(POSITIVE[rule][i])
    assert _rules_of(findings) == [rule]
    assert findings[0].severity == tan.RULE_CATALOG[rule][0]


@pytest.mark.parametrize("rule,i", [(r, i) for r in NEGATIVE for i in range(len(NEGATIVE[r]))])
def test_torch_rule_passes_its_negative_snippet(rule, i):
    findings, _ = _lint(NEGATIVE[rule][i])
    assert findings == []


def test_exempt_modules():
    assert _lint("import torch\ntorch.manual_seed(0)\n",
                 rel_path="torchdistx_tpu_torch/utils/rng.py")[0] == []
    assert _lint("import torch.distributed as dist\ndist.barrier()\n",
                 rel_path="torchdistx_tpu_torch/parallel/collectives.py")[0] == []


def test_catalog_names_tdx101_without_a_rule():
    ids = {r.rule_id for r in tan.default_rules()}
    assert "TDX101" not in ids
    assert set(tan.RULE_CATALOG) == ids | {"TDX100", "TDX101"} == set(jan.RULE_CATALOG)
    assert "no torch counterpart" in tan.RULE_CATALOG["TDX101"][1]
    for rid in ids | {"TDX100"}:  # the same severities as JAX's
        assert tan.RULE_CATALOG[rid][0] == jan.RULE_CATALOG[rid][0]


# -- the CLI -------------------------------------------------------------------------


def _run_cli(script, *args):
    return subprocess.run([sys.executable, str(script), *args], capture_output=True,
                          text=True, timeout=300)


def test_cli_strict_passes_on_the_tree_importing_neither_torch_nor_jax():
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{str(CLI)!r}, '--strict']\n"
        "try:\n"
        f"    runpy.run_path({str(CLI)!r}, run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax'))\n"
        "print('RC', rc, 'BAD', bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert "RC 0 BAD []" in out.stdout, out.stdout[-2000:] + out.stderr[-2000:]
    verdict = json.loads(out.stdout.strip().splitlines()[-2])
    assert verdict["ok"] and verdict["schema"] == "tdx-lint-verdict-v1"


def test_cli_fails_on_an_injected_finding_in_a_copy(tmp_path):
    for rel in ("torchdistx_tpu_torch", "scripts", "expectations"):
        shutil.copytree(ROOT / rel, tmp_path / rel,
                        ignore=shutil.ignore_patterns("__pycache__", "*.json.tmp"))
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    script = tmp_path / "scripts" / "torch_tdx_lint.py"
    assert _run_cli(script, "--strict").returncode == 0
    target = tmp_path / "torchdistx_tpu_torch" / "trainer.py"
    target.write_text(target.read_text() + "\ntorch.manual_seed(0)\n")
    out = _run_cli(script, "--strict")
    assert out.returncode == 1
    verdict = json.loads(out.stdout.strip().splitlines()[-1])
    (new,) = verdict["new"]
    assert (new["rule"], new["path"]) == ("TDX102", "torchdistx_tpu_torch/trainer.py")
    # the refresh pins it; a fix then fails as "fixed" until refreshed again
    assert _run_cli(script, "--update-baseline").returncode == 0
    assert _run_cli(script, "--strict").returncode == 0
    target.write_text(target.read_text().replace("\ntorch.manual_seed(0)\n", "\n"))
    assert _run_cli(script, "--strict").returncode == 1
    assert _run_cli(script, "--no-baseline", "--strict").returncode == 0
    assert _run_cli(script, "--baseline", str(tmp_path / "missing.json")).returncode == 2
