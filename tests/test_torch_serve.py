"""The port's serving CLI on the CPU, its refusal to run without a card
unless asked, and the rule that the port imports nothing of JAX."""

import ast
import pathlib

import pytest
import torch

from repro_torch import NotPortedError
from repro_torch.core import methods
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models.api import DeviceUnavailableError

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("merged", [False, True])
def test_cli_serves_on_cpu_and_reports_counters(merged, capsys):
    argv = ["--device", "cpu", "--gen", "2", "--batch", "2",
            "--prompt-len", "8"] + (["--merged"] if merged else [])
    res = serve.main(argv)
    out = capsys.readouterr().out
    assert res["tokens"].shape == (2, 3)
    assert res["logits"].shape == (2, 1, 512)
    assert torch.isfinite(res["logits"]).all()
    assert "decode:" in out and "generated:" in out
    assert f"kernel launches: {dict.fromkeys(ops.launches(), 0)}" in out
    assert "'householder_gemm': 0, 'ether_merge': 0" in out
    per_forward = 7 * 4                         # linears × smoke layers
    attention = {"flash_attention.torch": 4 * res["forwards"]}
    if merged:
        # each adapted linear merged once, then the plain model served
        want = {"ether_merge.torch": per_forward, **attention}
    else:
        want = {"householder_gemm.torch": per_forward * res["forwards"],
                **attention}
    assert f"dispatch counters: {want}" in out


def test_merged_and_unmerged_serving_agree_on_cpu():
    kw = dict(device="cpu", gen=3, batch=2, prompt_len=8, n_blocks=8)
    a = serve.serve(**kw)
    b = serve.serve(merged=True, **kw)
    assert torch.equal(a["tokens"], b["tokens"])
    err = (a["logits"] - b["logits"]).abs().max() / a["logits"].abs().max()
    assert err < 1e-5


def test_entry_points_raise_without_a_card_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError, match="--device cpu"):
        serve.main(["--gen", "1"])
    with pytest.raises(DeviceUnavailableError):
        serve.serve(device="cuda", gen=1)


@pytest.mark.parametrize("flag", ["--tenants=4", "--trace"])
def test_unported_modes_exit_naming_the_roadmap(flag):
    # --tenants alone is ported (tests/test_torch_bank.py); with --trace it
    # asks for the serve engine's replay, which is not
    with pytest.raises(SystemExit, match="not yet ported, see ROADMAP.md"):
        serve.main(["--device", "cpu", flag, "--trace"])


def test_unported_methods_raise_naming_the_roadmap():
    assert methods.available() == ("ether", "etherplus", "oft", "naive",
                                   "lora", "full", "delora", "hyperadapt")
    with pytest.raises(NotPortedError, match="ROADMAP.md"):
        methods.get("vera")
    with pytest.raises(NotPortedError, match="ROADMAP.md"):
        serve.serve(method="vera", device="cpu", gen=1)


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    for f in files:
        bad = {r for r in _imported_roots(f)
               if r in ("jax", "jaxlib", "repro") or r.startswith("flax")}
        assert not bad, f"{f.relative_to(REPO)} imports {sorted(bad)}"
