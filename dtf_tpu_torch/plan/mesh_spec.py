"""Mesh descriptor for the parallelism planner -- the port's
counterpart of ``dtf_tpu/plan/mesh_spec.py``.

A :class:`MeshSpec` is everything the analytic cost model needs to know
about the hardware -- device count and layout (hosts x devices/host),
memory bytes per device, achievable dense-matmul FLOP/s, and the two
collective-bandwidth tiers (intra-host vs cross-host).  It is
*simulatable*: a plan for four 8-card hosts can be ranked on a CPU box,
because nothing here requires the described hardware to be attached.
``MeshSpec``, ``axis_bandwidth`` and the descriptor parser are the JAX
package's code; the presets and the live mesh are the port's.

Presets.  ``cpu`` is the JAX package's (sized for an 8-rank test run on
a dev box).  ``h100x8`` is one host of eight NVIDIA H100 80GB HBM3
cards and ``4xh100x8`` four such hosts.  Their per-device numbers:

  hbm_bytes     what ``torch.cuda.get_device_properties(0).total_memory``
                reports on the card (``H100_HBM_BYTES``);
  device_flops  half of the 989 TFLOP/s dense bf16 peak of the data
                sheet -- the JAX presets' "achievable" convention;
  intra_bw      NVLink 4: 450 GB/s a direction (data sheet);
  inter_bw      one 400 Gb/s NIC a GPU: 50 GB/s (data sheet).

The two bandwidths are data-sheet figures, UNCALIBRATED: one card
cannot measure a link between two (``DATASHEET_UNCALIBRATED``).  The
JAX package's TPU presets (``v4-8``, ``4x4``) are not carried: their
numbers are a TPU's.

``mesh_spec("")`` describes the live run (:func:`live_mesh`): hosts
counted from the named topology, one device a rank, and on CUDA each
rank's share of its card.  ``calibrate_device_flops`` times a
forward+backward of ``transformer_small`` on the run's device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

KiB, MiB, GiB = 1024, 1024 ** 2, 1024 ** 3

# torch.cuda.get_device_properties(0).total_memory on an NVIDIA H100
# 80GB HBM3 (chip_smoke.py's planner phase checks it on the card)
H100_HBM_BYTES = 85_017_493_504
# the H100 dense bf16 peak of the data sheet, FLOP/s
H100_BF16_PEAK = 989e12
# the bandwidth fields that come from the data sheet, not a measurement
DATASHEET_UNCALIBRATED = ("intra_bw", "inter_bw")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Hardware description consumed by the cost model."""

    name: str
    num_hosts: int
    devices_per_host: int
    hbm_bytes: int        # per-device HBM (host RAM share for CPU)
    device_flops: float   # achievable dense FLOP/s per device
    intra_bw: float       # bytes/s per device for intra-host collectives
    inter_bw: float       # bytes/s per device once a ring crosses hosts

    def __post_init__(self):
        if self.num_hosts < 1 or self.devices_per_host < 1:
            raise ValueError(f"mesh {self.name!r}: needs >= 1 host and "
                             f">= 1 device per host")
        if min(self.hbm_bytes, self.device_flops, self.intra_bw,
               self.inter_bw) <= 0:
            raise ValueError(f"mesh {self.name!r}: hbm/flops/bandwidth "
                             f"must all be positive")

    @property
    def num_devices(self) -> int:
        return self.num_hosts * self.devices_per_host

    def axis_bandwidth(self, stride: int, size: int) -> float:
        """Per-device collective bandwidth for a mesh axis whose ring
        neighbors are ``stride`` devices apart (the rank grid is laid
        out row-major over the host-major rank list, so an axis's span
        is stride x size): a ring whose whole span fits in one host
        runs at the intra-host speed, anything wider is gated by the
        cross-host link."""
        if size <= 1:
            return self.intra_bw
        return (self.intra_bw if stride * size <= self.devices_per_host
                else self.inter_bw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


_H100 = dict(hbm_bytes=H100_HBM_BYTES, device_flops=H100_BF16_PEAK / 2,
             intra_bw=450e9, inter_bw=50e9)

PRESETS: Dict[str, MeshSpec] = {
    "cpu": MeshSpec("cpu", num_hosts=1, devices_per_host=8,
                    hbm_bytes=4 * GiB, device_flops=8e9,
                    intra_bw=8e9, inter_bw=1e9),
    "h100x8": MeshSpec("h100x8", num_hosts=1, devices_per_host=8, **_H100),
    "4xh100x8": MeshSpec("4xh100x8", num_hosts=4, devices_per_host=8,
                         **_H100),
}

_SUFFIX = {"k": 1e3, "m": 1e6, "g": 1e9, "t": 1e12, "p": 1e15}
# byte quantities use binary multipliers, so the descriptor "hbm=32g"
# means exactly 32 GiB -- not 32e9 B, a 7% discrepancy that would flip
# feasibility between two spellings
_BYTE_SUFFIX = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}


def _num(text: str, *, binary: bool = False) -> float:
    text = text.strip().lower()
    table = _BYTE_SUFFIX if binary else _SUFFIX
    if text and text[-1] in table:
        return float(text[:-1]) * table[text[-1]]
    return float(text)


def live_mesh(cfg=None, live_devices: Optional[int] = None) -> MeshSpec:
    """The mesh a run of ``cfg`` would get (``runtime/mesh.py
    topology``): hosts from the named topology, its ranks a host as
    devices, ``h100x8``'s per-device numbers on CUDA (each rank's share
    of its card when ranks share one), ``cpu``'s otherwise.
    ``live_devices`` bounds the devices a host (an explicit
    ``--num_devices``, or the survivors of an elastic shrink)."""
    from dtf_tpu_torch.runtime.mesh import topology

    topo = topology(cfg)
    local = (live_devices if live_devices is not None
             else topo["devices_per_host"])
    if topo["platform"] != "gpu":
        return dataclasses.replace(PRESETS["cpu"], name="runtime",
                                   num_hosts=topo["num_hosts"],
                                   devices_per_host=local)
    # the ranks that share a card, at the devices a host this mesh has
    share = -(-local // topo["cards_per_host"])
    return dataclasses.replace(
        PRESETS["h100x8"], name="runtime", num_hosts=topo["num_hosts"],
        devices_per_host=local,
        hbm_bytes=topo["device_memory"] // share,
        device_flops=PRESETS["h100x8"].device_flops / share)


def mesh_spec(spec: str = "", *, live_devices: Optional[int] = None,
              cfg=None) -> MeshSpec:
    """Resolve a ``--plan_mesh`` value.

    "" (default)    -- describe the live run of ``cfg``
                       (:func:`live_mesh`), so plans search the mesh a
                       run would actually get.
    preset name     -- one of PRESETS (``cpu``, ``h100x8``,
                       ``4xh100x8``).
    "k=v,..." string -- explicit descriptor, e.g.
                       ``hosts=4,devices=8,hbm=79g,flops=494t,intra=450g,inter=50g``
                       (numbers take k/m/g/t suffixes -- binary for hbm,
                       decimal for the rates).  Unset keys inherit from
                       the ``cpu`` preset.

    ``live_devices`` bounds the LIVE path's devices per host;
    presets/descriptors ignore it.
    """
    if not spec:
        return live_mesh(cfg, live_devices)
    if spec in PRESETS:
        return PRESETS[spec]
    if "=" not in spec:
        raise ValueError(
            f"unknown mesh preset {spec!r}; have {sorted(PRESETS)} or a "
            f"'hosts=4,devices=8,hbm=79g,flops=494t,intra=450g,inter=50g' "
            f"descriptor")
    base = PRESETS["cpu"]
    kw = dict(name=spec, num_hosts=base.num_hosts,
              devices_per_host=base.devices_per_host,
              hbm_bytes=base.hbm_bytes, device_flops=base.device_flops,
              intra_bw=base.intra_bw, inter_bw=base.inter_bw)
    keys = {"hosts": "num_hosts", "devices": "devices_per_host",
            "hbm": "hbm_bytes", "flops": "device_flops",
            "intra": "intra_bw", "inter": "inter_bw"}
    for part in spec.split(","):
        k, _, v = part.partition("=")
        k = k.strip().lower()
        if k not in keys:
            raise ValueError(f"unknown mesh descriptor key {k!r}; have "
                             f"{sorted(keys)}")
        val = _num(v, binary=(k == "hbm"))
        kw[keys[k]] = int(val) if keys[k] in ("num_hosts",
                                              "devices_per_host",
                                              "hbm_bytes") else val
    return MeshSpec(**kw)


def calibrate_device_flops(device="cuda", repeats: int = 3, *,
                           model: str = "transformer_small",
                           batch: int = 2, seq_len: int = 64,
                           num_classes: Optional[int] = None,
                           dtype=None) -> float:
    """Measured achievable FLOP/s for TRAINING-STEP-SHAPED work on one
    device of the run: ``device`` is the card unless the caller names
    the CPU (no card raises, as ``--device cuda`` does).

    A bare GEMM probe overestimates what a real step sustains (small
    per-op shapes, softmax/layernorm/optimizer traffic, launch
    overhead), so the probe is a forward+backward of an LM, divided by
    its ANALYTIC flop count (the cost model's accounting) -- the rate
    then carries the inefficiencies a predicted step will hit.  The
    defaults are the JAX package's probe: ``transformer_small`` in
    float32 at batch 2, seq 64.  ``model``/``batch``/``seq_len``/
    ``num_classes``/``dtype`` (the compute dtype; float32 when None)
    time another LM at a run's own shapes instead.  The port's probe is
    eager, one launch an op, where the JAX one is a single jitted
    program: at the default's tiny shapes it is launch-bound on a card.
    On CUDA it runs the attention kernels (K1 and K3).  One warm-up
    step first; the clock is read after ``synchronize``."""
    import torch
    import torch.nn.functional as F

    from dtf_tpu_torch.models.registry import build_model, is_vision
    from dtf_tpu_torch.plan.model_stats import characterize
    from dtf_tpu_torch.runtime.device import resolve_device

    if is_vision(model):
        raise ValueError(f"the FLOP/s probe times an LM, not {model!r}")
    dev = resolve_device(str(device))
    torch.manual_seed(0)
    net, _ = build_model(model, num_classes=num_classes,
                         dtype=dtype or torch.float32)
    net = net.to(dev).train()
    stats = characterize(model, seq_len=seq_len, num_classes=num_classes)
    tokens = torch.zeros((batch, seq_len), dtype=torch.long, device=dev)
    params = [p for p in net.parameters() if p.requires_grad]

    def step():
        logits = net(tokens)
        loss = F.cross_entropy(logits.float().flatten(0, 1),
                               tokens.flatten())
        return torch.autograd.grad(loss, params)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    step()              # warm-up: kernel loads, allocator, caches
    sync()
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = step()
    sync()
    dt = time.perf_counter() - t0
    del out
    # fwd + backward ~ 3x forward MACs -- the cost model's convention
    return repeats * 3.0 * stats.flops * batch / max(dt, 1e-9)
