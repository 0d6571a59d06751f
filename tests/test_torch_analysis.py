"""The port's static analysis (``repro_torch.analysis``) against the
reference's (``repro.analysis``): the AST rules over the reference's fixture
corpus and the port's own, the repository's scan, every kernel contract
check on a corrupted contract, and the CLI. CPU only; no card."""
import dataclasses
import json
import os
import re
from pathlib import Path
from unittest import mock

import pytest
import torch

from repro.analysis.rules import RULES as REF_RULES
from repro.analysis.visitor import scan_source as ref_scan_source
from repro_torch.analysis import BASELINE_NAME, repo_root, run_analysis
from repro_torch.analysis import kernel_contracts as kc
from repro_torch.analysis.__main__ import main
from repro_torch.analysis.findings import Baseline, Finding, parse_allows
from repro_torch.analysis.kernel_contracts import KRN_EXPLAIN, T
from repro_torch.analysis.rules import RULES
from repro_torch.analysis.visitor import scan_source
from repro_torch.kernels import flash_attention as FA

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures" / "analysis"
TORCH_FIXTURES = ROOT / "tests" / "fixtures" / "analysis_torch"
REF_FIXTURES = sorted(p.name for p in FIXTURES.glob("*.py"))
#: the rules whose meaning the two packages share; ARCH001 names each
#: package's own shims (Pallas and make_mesh there, the kernel library and
#: the process group here) and has fixtures of its own
SHARED = sorted(set(REF_RULES) & set(RULES) - {"ARCH001"})
#: where a fixture is scanned, in the reference and in the port: inside
#: every scope, outside DET001's, inside ARCH002's exemption, inside OBS001's
VPATHS = [("sim/fixture.py", "sim/fixture.py"), ("kernels/fixture.py", "kernels/fixture.py"),
          ("fl/api.py", "fl/api.py"), ("obs/fixture.py", "obs/fixture.py")]


def _pairs(findings):
    return [(f.rule, f.line) for f in findings]


# -- (i) the AST rules over the reference's fixtures --------------------------


def test_both_packages_have_every_rule_id():
    assert set(RULES) == set(REF_RULES)
    assert set(KRN_EXPLAIN) == {f"KRN00{i}" for i in range(1, 6)}


@pytest.mark.parametrize("vpath", VPATHS, ids=lambda v: v[0])
@pytest.mark.parametrize("fixture", REF_FIXTURES)
def test_shared_rules_agree_with_the_reference_on_its_fixtures(fixture, vpath):
    """Each engine scans the fixture at its own package's path: the same
    (rule, line) findings and the same number suppressed inline."""
    source = (FIXTURES / fixture).read_text()
    want, want_supp = ref_scan_source(source, "src/repro/" + vpath[0],
                                      [REF_RULES[r] for r in SHARED])
    got, got_supp = scan_source(source, "src/repro_torch/" + vpath[1],
                                [RULES[r] for r in SHARED])
    assert _pairs(got) == _pairs(want)
    assert _pairs(got_supp) == _pairs(want_supp)


@pytest.mark.parametrize("rule_id", SHARED)
def test_each_shared_rule_flags_its_bad_fixture_and_passes_its_ok_one(rule_id):
    vpath = "src/repro_torch/sim/fixture.py"
    bad, _ = scan_source((FIXTURES / f"{rule_id.lower()}_bad.py").read_text(), vpath,
                         [RULES[rule_id]])
    ok, _ = scan_source((FIXTURES / f"{rule_id.lower()}_ok.py").read_text(), vpath,
                        [RULES[rule_id]])
    assert bad and all(f.rule == rule_id and f.path == vpath for f in bad)
    assert ok == []


def test_the_reference_fixtures_of_arch001_are_no_concern_of_the_port():
    """The port's ARCH001 guards its own shims; the reference's Pallas and
    make_mesh fixture is JAX code, which the port never has."""
    got, _ = scan_source((FIXTURES / "arch001_bad.py").read_text(),
                         "src/repro_torch/sim/fixture.py", [RULES["ARCH001"]])
    assert got == []


# -- the port's own fixtures: ARCH001 and DET002's torch half ----------------


def _scan_torch(name, rule_id, vpath="src/repro_torch/fl/fixture.py"):
    return scan_source((TORCH_FIXTURES / name).read_text(), vpath, [RULES[rule_id]])


def _lines(name, pattern):
    text = (TORCH_FIXTURES / name).read_text().splitlines()
    return [i for i, t in enumerate(text, start=1) if re.search(pattern, t)]


def test_arch001_flags_the_kernel_library_and_meshes_outside_their_shims():
    got, _ = _scan_torch("arch001_bad.py", "ARCH001")
    want = _lines("arch001_bad.py", r"CDLL\(|_lib\.lib\(\)|init_process_group\(|"
                                    r"DeviceMesh\(\"|init_device_mesh\(\"")
    assert [f.line for f in got] == want and len(want) == 7
    ok, _ = _scan_torch("arch001_ok.py", "ARCH001")
    assert ok == []


@pytest.mark.parametrize("vpath,kept", [
    ("src/repro_torch/kernels/_lib.py", ("init_process_group(", 'DeviceMesh("',
                                         'init_device_mesh("')),
    ("src/repro_torch/launch/mesh.py", ("CDLL(", "_lib.lib()")),
    ("src/repro/kernels/fixture.py", ()),
])
def test_arch001_exempts_each_shim_from_its_own_api(vpath, kept):
    got, _ = _scan_torch("arch001_bad.py", "ARCH001", vpath)
    text = (TORCH_FIXTURES / "arch001_bad.py").read_text().splitlines()
    assert [f.line for f in got] == [i for i, t in enumerate(text, start=1)
                                     if any(k in t for k in kept)]


def test_det002_flags_torch_global_generator_draws():
    got, _ = _scan_torch("det002_bad.py", "DET002")
    want = _lines("det002_bad.py", r"torch\.|x\.\w+_\(")
    want = [ln for ln in want if ln > 5]  # past the docstring and the import
    assert [f.line for f in got] == want and len(want) == 15
    assert all(f.rule == "DET002" for f in got)
    ok, _ = _scan_torch("det002_ok.py", "DET002")
    assert ok == []


def test_det004_flags_a_torch_generator_built_in_a_draw_path():
    source = ("import torch\n\n\nclass Churn:\n    def __init__(self, seed):\n"
              "        self.gen = torch.Generator().manual_seed(seed)\n\n"
              "    def draw_round(self, r):\n"
              "        return torch.Generator().manual_seed(r)\n")
    got, _ = scan_source(source, "src/repro_torch/sim/churn.py", [RULES["DET004"]])
    assert _pairs(got) == [("DET004", 9)]


def test_parse_allows_positions():
    allows = parse_allows("x = 1\nt = clock()  # analysis: allow[DET001, DET002]\n"
                          "# analysis: allow[OBS001]\n")
    assert allows == {2: {"DET001", "DET002"}, 3: {"OBS001"}}


# -- (ii) the repository's scan -----------------------------------------------


def test_repo_ast_scan_is_clean_against_the_port_baseline():
    findings, suppressed = run_analysis(kernels=False)
    new, _ = Baseline.load(os.path.join(repo_root(), BASELINE_NAME)).split(findings)
    assert new == [], [f.render() for f in new]
    assert findings == []
    # the annotated host-only timing sites (fl/engine.py's wall_s and
    # round_s, fl/profile_round.py's wall times, fl/metrics.py's eval
    # timing, sim/engine.py's --profile-sim gauges), the pre-run label noise
    # derivation in sim/faults.py (DET004, two calls) and the scalar
    # migration draw loop in sim/churn.py (PERF001)
    assert len(suppressed) == 22
    assert {f.rule for f in suppressed} == {"DET001", "DET004", "PERF001"}


def test_the_port_baseline_is_empty():
    assert Baseline.load(str(ROOT / BASELINE_NAME)).keys == set()
    assert json.loads((ROOT / BASELINE_NAME).read_text()) == {"findings": []}


def test_kernel_contracts_hold():
    findings = kc.check_all()
    assert findings == [], [f.render() for f in findings]


def test_contract_table_is_deterministic_and_whole():
    a, b = kc.contract_table(), kc.contract_table()
    assert a == b and all(row["ok"] for row in a.values())
    assert set(a) == {"distill_loss", "softmax_xent", "skr_rectify", "skr_process",
                      "flash_attention_sm90", "flash_attention_tf32x3",
                      "flash_attention_decode", "flash_attention_latent_decode",
                      "flash_attention_empty_rows", "rwkv6_scan", "rwkv6_scan_chunked",
                      "rwkv6_scan_bwd"}
    assert a["distill_loss"]["vjp"] == "autograd.Function"
    assert a["skr_process"]["vjp"] == "wrapper-only"
    assert a["flash_attention_sm90"]["vjp"] == "forward-only"


def test_every_kernel_and_c_entry_has_a_contract():
    """Every __global__ function of csrc/ is some contract's kernel in its
    source, and every C entry is some contract's launch or query entry."""
    kernels = set()
    for path in kc.CSRC.glob("*.cu"):
        text = path.read_text()
        for m in re.finditer(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                             text):
            kernels.add((path.name, m.group(1)))
    covered = {(c.source, k) for c in kc.CONTRACTS.values() for k in c.kernels}
    assert kernels == covered
    entries = {n for c in kc.CONTRACTS.values() for n in (*c.c_entries, c.attrs_entry)}
    assert set(kc.c_entries()) - entries == {"rwkv6_scan_bwd_smem"}
    assert {i.kernel for c in kc.CONTRACTS.values() for i in c.instances} == \
        {k for _, k in kernels}


def test_the_mirror_agrees_with_the_sources_limits():
    """Every instance's shared memory is within sm_90's limits (the kernels'
    static_asserts are the same), and the three that may spill are the
    instances no config reaches."""
    spills = {(c.name, i.name) for c, i in kc.all_instances() if i.spills}
    assert spills == {("flash_attention_tf32x3", "flash_tf32x3_kernel<bf16, 256, 256>"),
                      ("flash_attention_decode", "flash_decode_split<float, 112, 4>"),
                      ("rwkv6_scan", "rwkv6_kernel<128>")}
    assert max(i.static_smem + i.dynamic_smem for _, i in kc.all_instances()) <= kc.SMEM_OPTIN


# -- (iii) each check catches its corrupted contract --------------------------

DL = kc.CONTRACTS["distill_loss"]
SM90 = kc.CONTRACTS["flash_attention_sm90"]


def _rules(findings):
    return sorted({f.rule for f in findings})


def test_krn001_catches_a_wrong_output_shape():
    bad = dataclasses.replace(DL, expect=lambda s: (T((1, 2, 3)),))
    assert _rules(kc.check_trace(bad, DL.shapes[0])) == ["KRN001"]
    assert kc.check_trace(DL, DL.shapes[0]) == []


def test_krn001_catches_a_call_that_reaches_another_familys_entry():
    bad = dataclasses.replace(SM90, c_entries=("flash_attention",))
    assert _rules(kc.check_trace(bad, SM90.shapes[0])) == ["KRN001"]


C_INT = kc.ctypes.c_int


def _sigs(**change):
    from repro_torch.kernels import _lib

    return {**_lib._SIGNATURES, **change}


@pytest.mark.parametrize("name,change", [
    # an argument dropped: the stream would land in rows' place
    ("skr_rectify", lambda a: a[:-2] + a[-1:]),
    # an int where C takes long long: q_offset cut to 32 bits
    ("flash_attention_sm90", lambda a: [C_INT if i == 13 else t for i, t in enumerate(a)]),
    # a float where C takes int
    ("rwkv6_scan", lambda a: [kc.ctypes.c_float if i == 8 else t for i, t in enumerate(a)]),
])
def test_krn001_catches_a_signature_that_disagrees_with_its_c_entry(name, change):
    from repro_torch.kernels import _lib

    args = list(_lib._SIGNATURES[name])
    got = kc.check_signatures(_sigs(**{name: change(args)}))
    assert _rules(got) == ["KRN001"] and name in got[0].message
    assert kc.check_signatures() == []


def test_krn001_catches_a_name_with_no_counterpart():
    from repro_torch.kernels import _lib

    sigs = dict(_lib._SIGNATURES)
    del sigs["rwkv6_scan_attrs"]
    sigs["flash_attention_fwd"] = [kc.ctypes.c_void_p]
    got = kc.check_signatures(sigs)
    assert [f.rule for f in got] == ["KRN001", "KRN001"]
    assert {f.path for f in got} == {"src/repro_torch/csrc/rwkv6_scan.cu",
                                     "src/repro_torch/kernels/_lib.py"}


def test_c_entries_read_argument_kinds():
    src = {"x.cu": 'extern "C" int f(const float* a, long long n, int k, float s, '
                   "cudaStream_t stream) {\n}\n"}
    assert kc.c_entries(src) == {"f": ("x.cu", 1, ["pointer", "long long", "int", "float",
                                                   "stream"])}


@pytest.mark.parametrize("kwargs,what", [
    (dict(sm90=tuple(p for p in FA.SM90_INSTANCES if p != (256, 256))), "gemma3-12b"),
    (dict(tf32x3=tuple(p for p in FA.TF32X3_INSTANCES if p != (192, 128))),
     "deepseek-v2-lite-16b"),
    (dict(decode=(32, 64, 128, 256)), "zamba2-7b"),
    (dict(rwkv=(16, 32, 128)), "rwkv6-1.6b"),
    (dict(latent=(512, 64, 8)), "deepseek-v2-lite-16b"),
])
def test_krn002_catches_a_head_dim_with_no_instance(kwargs, what):
    got = kc.check_coverage(**kwargs)
    assert _rules(got) == ["KRN002"] and all(what in f.message for f in got)
    assert kc.check_coverage() == []


def test_krn002_catches_a_plan_that_breaks_its_kernels_rules():
    from repro_torch.kernels import flash_attention as FA

    def unaligned(*a):
        j_lo, chunk, splits = FA._decode_plan(*a)
        return j_lo, chunk + 1 if chunk else 0, splits

    def too_many(B, S, q_offset):
        chunk, splits, vsplits = FA._latent_plan(B, S, q_offset)
        return chunk // 2 or 32, 2 * splits, vsplits

    assert _rules(kc.check_plans(decode_plan=unaligned)) == ["KRN002"]
    assert _rules(kc.check_plans(latent_plan=too_many)) == ["KRN002"]
    src = {p.name: p.read_text() for p in kc.CSRC.glob("*.cu")}
    src["flash_attention_latent_decode.cu"] = src["flash_attention_latent_decode.cu"].replace(
        "constexpr int kMaxSplits = 16;", "constexpr int kMaxSplits = 8;")
    got = kc.check_plans(sources=src)
    assert _rules(got) == ["KRN002"] and "kMaxSplits" in got[0].message
    assert kc.check_plans() == []


def test_krn002_catches_a_grid_past_cudas_limits():
    shape = dict(SM90.shapes[0], B=70_000)
    assert _rules(kc.check_grids(SM90, shape)) == ["KRN002"]
    assert kc.check_grids(SM90, SM90.shapes[0]) == []


def _with(contract, **change):
    first = dataclasses.replace(contract.instances[0], **change)
    return dataclasses.replace(contract, instances=(first, *contract.instances[1:]))


@pytest.mark.parametrize("contract,change", [
    (SM90, dict(dynamic_smem=240_000, opt_in=240_000)),  # over 227 KiB
    (SM90, dict(opt_in=None)),  # over 48 KB with no opt-in
    (kc.CONTRACTS["skr_process"], dict(static_smem=50_000)),  # static over 48 KB
    (kc.CONTRACTS["rwkv6_scan"], dict(threads=1024, min_blocks=4)),  # 4,096 threads an SM
])
def test_krn003_catches_resources_past_sm90s(contract, change):
    assert _rules(kc.check_resources(_with(contract, **change))) == ["KRN003"]
    assert kc.check_resources(contract) == []


def test_krn003_catches_a_source_with_no_opt_in():
    src = kc._source(SM90).replace("cudaFuncAttributeMaxDynamicSharedMemorySize", "0")
    got = kc.check_resources(SM90, source=src)
    assert _rules(got) == ["KRN003"] and len(got) == len(SM90.instances)


def test_krn003_limit_is_the_flag():
    assert _rules(kc.check_resources(SM90, limit=100_000)) == ["KRN003"]


def test_krn004_catches_a_bf16_accumulator():
    src = kc._source(SM90).replace("m64n64k16.f32.bf16.bf16", "m64n64k16.bf16.bf16.bf16", 1)
    got = kc.check_fp32_accum(SM90, source=src)
    assert _rules(got) == ["KRN004"] and "bf16" in got[0].message
    assert kc.check_fp32_accum(SM90) == []


def test_krn004_catches_a_tensor_core_kernel_with_no_product():
    src = re.sub(r'"\s*wgmma\.mma_async[^"]*"', '""', kc._source(SM90))
    assert _rules(kc.check_fp32_accum(SM90, source=src)) == ["KRN004"]


def test_mma_instructions_read_the_accumulator_type():
    src = ('asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0}");\n'
           '"wgmma.mma_async.sync.aligned.m64n48k16.f16.bf16.bf16 "')
    assert [(i[0], i[2]) for i in kc.mma_instructions(src)] == [(1, "f32"), (2, "f16")]


def test_krn005_catches_an_entry_that_is_no_autograd_function():
    bad = dataclasses.replace(DL, function="distill_loss")
    assert _rules(kc.check_vjp_pairing(bad, DL.shapes[0])) == ["KRN005"]
    assert kc.check_vjp_pairing(DL, DL.shapes[0]) == []


def test_krn005_catches_a_wrapper_that_is_no_b1_slice():
    bad = dataclasses.replace(DL, wrapper="distill_loss_batched")
    assert _rules(kc.check_vjp_pairing(bad, DL.shapes[0])) == ["KRN005"]


def test_krn005_catches_a_forward_only_wrapper_that_lets_grad_through():
    from repro_torch.kernels import _lib

    with mock.patch.object(_lib, "refuse_grad"):
        assert _rules(kc.check_vjp_pairing(SM90, SM90.shapes[0])) == ["KRN005"]
    assert kc.check_vjp_pairing(SM90, SM90.shapes[0]) == []


def test_meta_trace_of_a_differentiable_entry_reaches_its_backward():
    got = kc.trace(kc.CONTRACTS["rwkv6_scan_bwd"], kc.CONTRACTS["rwkv6_scan_bwd"].shapes[0])
    assert got["grad_fn"] == "Rwkv6ScanBackward"
    assert got["entries"] == ["rwkv6_scan_chunked", "rwkv6_scan_bwd"]
    assert got["grad"] == T((2, 1024, 32, 64))


def test_skr_wrappers_refuse_grad_on_the_card_path_and_run_plain_on_the_cpu():
    """The SKR kernels have no backward: a probability that requires grad
    is refused where the kernel would run (here meta), and the CPU's plain
    version still runs under autograd."""
    from repro_torch.kernels.skr_rectify import skr_process_rows, skr_rectify

    for dev in ("meta", "cpu"):
        p = torch.full((4, 3), 1 / 3, device=dev).requires_grad_(True)
        y = torch.zeros(4, dtype=torch.long, device=dev)
        q = torch.zeros((3, 2), device=dev)
        cnt = torch.zeros(3, dtype=torch.int32, device=dev)
        calls = (lambda: skr_rectify(p, y, q[:, 0], cnt),
                 lambda: skr_process_rows(p, y, q, cnt, cnt.clone()))
        for call in calls:
            if dev == "meta":
                with pytest.raises(RuntimeError, match="no backward"):
                    call()
            else:
                out = call()
                assert (out[0] if isinstance(out, tuple) else out).shape == (4, 3)


# -- (iv) the CLI ---------------------------------------------------------------


@pytest.mark.parametrize("rule_id", sorted(RULES) + sorted(KRN_EXPLAIN))
def test_explain_answers_for_every_rule(rule_id, capsys):
    assert main(["--explain", rule_id.lower()]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"{rule_id}: ") and len(out.splitlines()) >= 2


def test_explain_refuses_an_unknown_rule(capsys):
    assert main(["--explain", "XYZ999"]) == 2
    assert "known rules" in capsys.readouterr().err


def test_clean_run_and_json(capsys):
    assert main([]) == 0
    assert capsys.readouterr().out.startswith("OK: 0 finding(s), 0 grandfathered, 22 ")
    assert main(["--json", "--no-kernels"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["new"] == [] and doc["grandfathered"] == [] and len(doc["suppressed"]) == 22


def test_write_baseline_round_trips(tmp_path, capsys):
    pkg = tmp_path / "src" / "repro_torch" / "sim"
    pkg.mkdir(parents=True)
    (pkg / "clock.py").write_text("import time\n\n\ndef now():\n    return time.time()\n")
    base = str(tmp_path / "baseline.json")
    argv = ["--root", str(tmp_path), "--no-kernels", "--baseline", base]
    assert main(argv) == 1
    assert "src/repro_torch/sim/clock.py:5: DET001" in capsys.readouterr().out
    assert main(argv + ["--write-baseline"]) == 0
    assert Baseline.load(base).keys == {"DET001:src/repro_torch/sim/clock.py:5"}
    capsys.readouterr()
    assert main(argv) == 0
    assert "1 grandfathered" in capsys.readouterr().out
    assert main(argv + ["--json"]) == 0
    assert [f["rule"] for f in json.loads(capsys.readouterr().out)["grandfathered"]] == \
        ["DET001"]
    # a finding the baseline does not hold still fails
    new, old = Baseline.load(base).split([Finding("DET001", "src/repro_torch/sim/x.py", 3, "")])
    assert [f.path for f in new] == ["src/repro_torch/sim/x.py"] and old == []


def test_smem_limit_flag_reaches_krn003(capsys):
    assert main(["--smem-limit", "100000"]) == 1
    assert "KRN003" in capsys.readouterr().out
