#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py`` on the CPU before spending card time on it.

    PYTHONPATH=src python3 tools/rehearse_chip_smoke.py [PART ...]

Runs the script's control flow at smoke widths with the card's calls
faked: ``torch.cuda.Event`` times on the host clock, ``device="cuda"``
tensors and generators land on the CPU, the "full" configs are the smoke
ones, and phase 2's direct kernel launchers return their plain versions.
The wrappers then take their plain versions (CPU tensors), so every
launch-count check fails; ``check`` prints its failures instead of
raising, and whatever else fails (a wrong key, shape or argument) raises
as it would on the card.  No time printed here is a device time.

PART picks phases instead of the whole script: ``rows`` (phase 2's
DeLoRA and HyperAdapt rows), ``bankrows`` (phase 2's bank rows),
``serve:<method>`` (phase 7's serving), ``train:<method>`` (phase 4's
training), ``base`` (phase 11), ``bank:<method>`` (phase 12's bank
serving of ether, etherplus, delora or hyperadapt), ``mergerows``
(phase 2's merge backward rows), ``weight:<method>`` (phase 13's
weight-mode training, then for ether and etherplus its blockgemm run).
"""

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(REPO, "src"), REPO]

import torch  # noqa: E402

_Generator = torch.Generator


class _HostGenerator(_Generator):
    """A CPU generator whatever device is asked for."""

    def __new__(cls, device=None):
        return _Generator.__new__(cls)

    def __init__(self, device=None):
        super().__init__()


class _HostEvent:
    def __init__(self, **kw):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def _on_host(fn):
    def wrapped(*a, **kw):
        if kw.get("device") == "cuda":
            kw["device"] = "cpu"
        return fn(*a, **kw)
    return wrapped


def fake_card():
    torch.cuda.is_available = lambda: True
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.cuda.get_device_name = lambda *a: "cpu rehearsal"
    torch.cuda.device_count = lambda: 1
    torch.cuda.Event = _HostEvent
    torch.Generator = _HostGenerator
    torch.Tensor.cuda = lambda self, *a, **k: self
    for name in ("randn", "randint", "rand", "zeros", "ones", "full",
                 "empty", "tensor", "as_tensor", "arange"):
        setattr(torch, name, _on_host(getattr(torch, name)))

    import repro_torch.configs as configs
    from repro_torch.kernels import etherplus_merge, etherplus_reflect_bwd
    from repro_torch.kernels import merge_bwd
    from repro_torch.kernels import ref, reflect_gemm_dw, reflect_gemm_dx
    from repro_torch.launch import serve, steps
    from repro_torch.models import api
    from repro_torch.runtime import trainer
    get = configs.get_config
    configs.get_config = serve.get_config = (
        lambda arch, variant="smoke": get(arch, "smoke"))
    for mod in (api, trainer, steps, serve):
        mod.resolve_device = lambda device="cuda": torch.device("cpu")
    etherplus_merge.launch_left = lambda w, u, v: (
        0, ref.ref_etherplus_merge_left(w, u, v))
    etherplus_merge.launch_right = lambda w, u, v: (
        0, ref.ref_etherplus_merge_right(w, u, v))
    reflect_gemm_dx.launch = lambda x, w, u, g, v=None: (
        0, *ref.ref_reflect_gemm_dx(x, w, u, g, v))
    reflect_gemm_dw.launch = lambda x, u, g, v=None: (
        0, ref.ref_reflect_gemm_dw(x, u, g, x.dtype, v))
    etherplus_reflect_bwd.launch = lambda y, u, v, g: (
        0, *ref.ref_etherplus_reflect_bwd(y, u, v, g))
    merge_bwd.launch_left = lambda w, u, g, v, need_dw: (
        0, *ref.ref_merge_left_bwd(w, u, g, v, need_dw=need_dw))
    merge_bwd.launch_right = lambda w, u, v, g: (
        0, *ref.ref_etherplus_reflect_bwd(w, u, v, g))


def small(cs, failed):
    """chip_smoke's sizes cut to the smoke configs, its checks printed."""
    cs.check = lambda ok, what: ok or failed.append(what) or print(
        "CHECK FAILED:", what[:300])
    cs.LINEARS = {"smollm-360m": [(96, 96), (96, 32), (96, 256), (256, 96)],
                  "llama-2-7b": [(128, 128)]}
    cs.LAYER = {(96, 96): 2, (96, 32): 2, (96, 256): 2, (256, 96): 1}
    cs.ROWS, cs.BWD_ROWS, cs.BWD_RAGGED = (4, 20), (40,), 37
    cs.BANK_ROWS = ((4, 1), (8, 5), (4, 3))
    cs.TRAIN_B, cs.TRAIN_S, cs.TRAIN_STEPS, cs.TRAIN_CKPT = 2, 20, 4, 2
    cs.GEN = 4
    cs.timed_ms = lambda torch, fns: (fns[0](), 0.0)[1]
    cs.phase_device_and_build = lambda torch, build: "cpu rehearsal"
    cs.trace_steps = lambda torch, run, steps: (run(), {
        "profiled_wall_ms": 1.0, "device_busy_ms": 0.0, "busiest_ms": [],
        "top_level_ops": {"aten": 0}, "top_level_cpu_us": {"aten": 0.0},
        "top_level_cpu_ms": 0.0})[1]


def main(parts):
    fake_card()
    import chip_smoke as cs
    from repro_torch.core import execute
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import serve
    from repro_torch.models import api
    failed = []
    small(cs, failed)
    for part in parts:
        name, _, method = part.partition(":")
        if name == "rows":
            print(len(cs.method_kernel_rows(torch, ops, ref)), "rows")
        elif name == "serve":
            cs.phase_serve_method(torch, execute, ops, serve, api, 7,
                                  method)
        elif name == "train":
            cs.phase_train(torch, execute, ops, 4, method)
        elif name == "base":
            cs.phase_baselines(torch, execute, ops, serve)
        elif name == "bankrows":
            print(len(cs.bank_kernel_rows(torch, ops, ref)), "rows")
        elif name == "bank":
            cs.phase_serve_bank(torch, execute, ops, serve, api, method)
        elif name == "mergerows":
            from repro_torch.kernels import merge_bwd
            print(len(cs.merge_bwd_rows(torch, ops, ref, merge_bwd)), "rows")
        elif name == "weight":
            r = cs.phase_train(torch, execute, ops, 13, method, "weight",
                               *cs.WEIGHT_STEPS[method],
                               cs.moved_off_init(torch, method))
            if method in ("ether", "etherplus"):
                cs.phase_blockgemm(torch, execute, ops, method, r)
        else:
            raise SystemExit(f"unknown part {part!r}")
    if not parts:
        cs.main()
    others = [f for f in failed if "launched" not in f]
    print(f"{len(failed)} checks failed, {len(others)} of them not "
          f"launch counts:")
    for f in others:
        print(" -", f[:300])
    return 1 if others else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
