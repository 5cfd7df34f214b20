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

PART picks phases instead of the whole script: ``gemmrows`` (phase 2's
householder_gemm and ether_merge rows), ``rows`` (phase 2's DeLoRA and
HyperAdapt rows), ``eprows`` (phase 2's ETHER+ forward and merge
rows), ``bankrows`` (phase 2's bank rows),
``serve`` (phase 3's serving), ``serve:<method>`` (phase 7's serving), ``train:<method>`` (phase 4's
training), ``base`` (phase 11), ``bank:<method>`` (phase 12's bank
serving of ether, etherplus, delora or hyperadapt), ``mergerows``
(phase 2's merge backward rows), ``weight:<method>`` (phase 13's
weight-mode training, then for ether and etherplus its blockgemm run),
``bwdrows`` (phase 2's backward rows, Llama-2-7B's among them),
``bankbwdrows`` (phase 2's bank backward rows), ``banktrain:<method>``
(phase 14's training through a bank), ``ssdrows`` (phase 2's SSD rows),
``mamba`` (phase 15's Mamba-2 serving), ``reflectrows`` (phase 2's
standalone reflection rows), ``registry`` (phase 16: every forward op
dispatched under autograd; here the ``cuda`` backend is let through on
CPU tensors, so its wrappers take their plain versions), ``flashrows``
(phase 2's flash attention rows), ``qwen`` (phase 17's qwen2.5-32b
serving, at the smoke config), ``host`` (phase 2's host cost of a
decode step's ``householder_gemm`` calls).
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
    reflect_gemm_dx.launch = lambda x, w, u, g, v=None, on=None: (
        0, *ref.ref_reflect_gemm_dx(x, w, u, g, v))
    reflect_gemm_dw.launch = lambda x, u, g, v=None: (
        0, ref.ref_reflect_gemm_dw(x, u, g, x.dtype, v))
    etherplus_reflect_bwd.launch = lambda y, u, v, g: (
        0, *ref.ref_etherplus_reflect_bwd(y, u, v, g))
    merge_bwd.launch_left = lambda w, u, g, v, need_dw: (
        0, *ref.ref_merge_left_bwd(w, u, g, v, need_dw=need_dw))
    merge_bwd.launch_right = lambda w, u, v, g: (
        0, *ref.ref_etherplus_reflect_bwd(w, u, v, g))
    from repro_torch.kernels import batched

    def hh_bwd(x, w, u, ids, g, on=None):
        dx, gh = ref.ref_householder_gemm_batched_bwd(x, w, u, ids, g)
        return 0, dx, gh, ref.bank_grad(u, ids, gh)

    def ep_bwd(x, u, v, ids, g):
        dx, gu, gv = ref.ref_etherplus_reflect_batched_bwd(x, u, v, ids, g)
        return 0, dx, gu, gv, ref.bank_grad(u, ids, gu), ref.bank_grad(
            v, ids, gv)
    batched.householder_gemm_batched_bwd = hh_bwd
    batched.householder_gemm_batched_dw = lambda x, u, ids, g: (
        0, ref.ref_householder_gemm_batched_dw(x, u, ids, g, x.dtype))
    batched.etherplus_reflect_batched_bwd = ep_bwd
    batched.householder_gemm_batched = lambda x, w, u, ids, on=None: (
        0, ref.ref_householder_gemm_batched(x, w, u, ids), on or "simt")
    batched.hyperadapt_gemm_batched = (
        lambda x, w, r, c, ids, w_t=False, on=None: (
            0, ref.ref_hyperadapt_gemm_batched(x, w.T if w_t else w, r, c,
                                               ids), on or "simt"))

    def dl(x, w, a, b, s, ids, w_t=False, dx=False, on=None, stage=True,
           staged=None):
        if dx:   # the backward's dx: the banks as the forward holds them
            a, b = b.transpose(1, 2), a.transpose(1, 2)
        if staged is not None:   # the tiles the rule stages, as counted
            import chip_smoke
            got, tiles = chip_smoke.staged_tiles(ids, x.shape[1], a.shape[0])
            staged += torch.tensor([got if stage else 0, tiles],
                                   dtype=staged.dtype)
        return (0, ref.ref_delora_gemm_batched(x, w.T if w_t else w, a, b, s,
                                               ids), on or "simt")
    batched.delora_gemm_batched = dl
    from repro_torch.kernels import hyperadapt_gemm
    hyperadapt_gemm.launch = lambda x, w, r, c=None, w_t=False, on=None: (
        0, ref.ref_hyperadapt_gemm(x, w.T if w_t else w, r, c), on or "simt")
    from repro_torch.kernels import etherplus_gemm
    etherplus_gemm.launch = (
        lambda x, w, u1, v1, u2=None, v2=None, on=None, epi=None: (
            0, ref.ref_etherplus_gemm(x, w, u1, v1, u2, v2), on or "simt"))
    from repro_torch.kernels import ether_reflect, ether_reflect_bwd
    ether_reflect.launch = lambda x, u: (0, ref.ref_ether_reflect(x, u))
    ether_reflect.launch_batched = lambda x, u, ids: (
        0, ref.ref_ether_reflect_batched(x, u, ids))
    ether_reflect_bwd.launch = lambda x, u, g: (
        0, *ref.ref_ether_reflect_bwd(x, u, g))
    ether_reflect_bwd.launch_batched = lambda x, u, ids, g: (
        0, *ref.ref_ether_reflect_batched_bwd(x, u, ids, g))
    # phase 16 dispatches on "cuda" by name: let it through on the host
    from repro_torch.core import execute
    select = execute.selected_backend
    execute.selected_backend = lambda op, backend, *args, **kw: (
        backend if backend == "cuda" else select(op, backend, *args, **kw))


def small(cs, failed):
    """chip_smoke's sizes cut to the smoke configs, its checks printed."""
    cs.check = lambda ok, what: ok or failed.append(what) or print(
        "CHECK FAILED:", what[:300])
    cs.LINEARS = {"smollm-360m": [(96, 96), (96, 32), (96, 256), (256, 96)]}
    cs.WIDE_LINEARS = {"llama-2-7b": [(128, 128)]}
    cs.WIDE_BWD_BANK = (2, 20)
    cs.LAYER = {(96, 96): 2, (96, 32): 2, (96, 256): 2, (256, 96): 1}
    cs.ROWS, cs.BWD_ROWS, cs.BWD_RAGGED = (4, 20), (40,), 37
    cs.BANK_ROWS = ((4, 1), (8, 5), (4, 3))
    cs.BANK_WIDE_DECODE = (cs.BANK_TENANTS, 1)
    cs.TRAIN_B, cs.TRAIN_S, cs.TRAIN_STEPS, cs.TRAIN_CKPT = 2, 20, 4, 2
    cs.BANK_BWD_ROWS = ((4, 1), (2, 20), (4, 7))
    cs.BANK_TRAIN_IDS = [5, cs.BANK_TENANTS - 1]
    cs.SSM_LINEARS = {"mamba2-1.3b": [(64, 304), (128, 64)]}
    cs.SSD_SHAPE = dict(b=2, h=8, p=16, g=1, n=16, chunk=8)
    cs.SSD_SEQS = (5, 20, 32)
    cs.REFLECT_ROWS = (4, 40, 37)
    cs.REGISTRY_LINEAR = (96, 256)
    cs.MAMBA_PROMPTS, cs.MAMBA_TRUE_LENS = (20, 5), [20, 13, 5, 1]
    cs.FLASH_ROWS = (("qwen2.5-32b prefill", 1, 5, 1, 40, 40, 64, 0, None),
                     ("ragged, window 1024", 1, 5, 1, 37, 37, 64, 0, 16),
                     ("cached-prefix chunk", 1, 5, 1, 8, 40, 64, 32, None),
                     ("smollm-360m prefill", 4, 3, 1, 8, 8, 32, 0, None),
                     ("smollm-360m decode", 4, 3, 1, 1, 12, 32, 11, None),
                     ("qwen2.5-32b decode", 1, 5, 1, 1, 41, 128, 40, None),
                     ("fully masked rows", 1, 4, 2, 64, 32, 64, 40, 16),
                     ("ragged D=64 prefill", 2, 15, 5, 50, 50, 64, 0, None),
                     ("4 rows, window 1024", 1, 8, 2, 4, 200, 128, 190, 16),
                     ("D=32 prefill", 1, 4, 2, 40, 40, 32, 0, None),
                     ("poisoned neighbour", 1, 8, 2, 20, 20, 128, 0, None))
    cs.QWEN_P = 20
    cs.HOST_CALLS = 20
    from repro_torch.kernels import batched, householder_gemm
    from repro_torch.kernels import hyperadapt_gemm
    householder_gemm.map_counts = batched.hyperadapt_map_counts = \
        batched.delora_map_counts = hyperadapt_gemm.map_counts = \
        lambda: {"lookups": 0, "encodes": 0}
    cs.QWEN_LINEARS = {"qwen2.5-32b": [(80, 80), (80, 16), (80, 216),
                                       (216, 80)]}
    cs.GEN = 4
    cs.timed_ms = lambda torch, fns: (fns[0](), 0.0)[1]
    cs.phase_device_and_build = lambda torch, build: "cpu rehearsal"
    cs.trace_steps = lambda torch, run, steps: (run(), {
        "profiled_wall_ms": 1.0, "device_busy_ms": 0.0, "busiest_ms": [],
        "flash_ms": 0.0,
        "top_level_ops": {"aten": 0}, "top_level_cpu_us": {"aten": 0.0},
        "top_level_cpu_ms": 0.0, "processing_s": 0.0, "dxr_ms": {},
        "fwd_ms": {}})[1]


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
        if name == "gemmrows":
            print(len(cs.phase_kernels(torch, ops, ref)), "rows")
        elif name == "rows":
            print(len(cs.method_kernel_rows(torch, ops, ref)), "rows")
        elif name == "eprows":
            from repro_torch.kernels import etherplus_merge
            print(len(cs.etherplus_kernel_rows(torch, ops, ref,
                                               etherplus_merge)), "rows")
        elif name == "serve" and not method:
            cs.phase_serve(torch, execute, ops, serve, api)
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
        elif name == "bwdrows":
            from repro_torch.kernels import batched, etherplus_reflect_bwd
            from repro_torch.kernels import reflect_gemm_dw, reflect_gemm_dx
            print(len(cs.bwd_kernel_rows(torch, ops, ref, reflect_gemm_dx,
                                         reflect_gemm_dw,
                                         etherplus_reflect_bwd))
                  + len(cs.wide_bwd_rows(torch, ops, ref, reflect_gemm_dx,
                                         batched)), "rows")
        elif name == "bankbwdrows":
            from repro_torch.kernels import batched
            print(len(cs.bank_bwd_rows(torch, ops, ref, batched)), "rows")
        elif name == "banktrain":
            single = {"steady_ms": 1.0, "tokens_per_s": 1.0, "peak_gb": 0.0,
                      "trace": {"device_busy_ms": 0.0,
                                "top_level_ops": {"aten": 0}}}
            cs.phase_bank_train(torch, execute, ops, api, method, single,
                                "cpu rehearsal")
        elif name == "ssdrows":
            print(len(cs.ssd_kernel_rows(torch, ops, ref)), "rows")
        elif name == "mamba":
            cs.phase_serve_mamba(torch, execute, ops, serve, api)
        elif name == "reflectrows":
            from repro_torch.kernels import ether_reflect, ether_reflect_bwd
            print(len(cs.reflect_kernel_rows(torch, ops, ref, ether_reflect,
                                             ether_reflect_bwd)), "rows")
        elif name == "registry":
            cs.phase_registry(torch, execute, ops)
        elif name == "flashrows":
            print(len(cs.flash_kernel_rows(torch, ops, ref)), "rows")
        elif name == "qwen":
            cs.phase_serve_qwen(torch, execute, ops, serve, api)
        elif name == "host":
            cs.host_cost(torch, ops, execute)
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
