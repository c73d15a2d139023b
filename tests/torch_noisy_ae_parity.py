"""One fedqcs-ae round of each noisy-uplink configuration of chip_smoke.py's
[channels] phase, at the paper's width (K = 30, N = 1591, M = 530, Q = 3,
kernel route with scalar variance), in both packages on the CPU: the
reference's engine as its ``run_federated`` builds it, and the port's from
the same initial weights and sensing matrix with the reference's channel
draws injected through ``CohortEngine(draw=...)``.  Prints one JSON line per
configuration: each package's nmse, nu_channel and nu_quant stats and the
decoded aggregates' NMSE against each other.

    PYTHONPATH=src:tests python tests/torch_noisy_ae_parity.py   # ~1 min
"""

import json
import time

import jax
import numpy as np

from repro.core import compression as jcomp
from repro.data import mnist as jmnist
from repro.fed import engine as jeng
from repro.fed.channel import ChannelConfig as JChan
from repro.fed.partition import PartitionConfig as JPart
from repro.fed.partition import partition_indices as jpart
from repro.fed.scheduler import SchedulerConfig as JSched
from repro.fed.server_opt import ServerOptConfig as JSrv
from repro.paper import mlp as jmlp
from repro_torch.convert import from_reference
from repro_torch.core.compression import FedQCSConfig as TCfg
from repro_torch.fed import engine as teng
from repro_torch.fed.channel import ChannelConfig as TChan
from repro_torch.fed.scheduler import SchedulerConfig as TSched
from repro_torch.fed.server_opt import ServerOptConfig as TSrv
from repro_torch.paper import mlp as tmlp
from torch_fed_parity import reference_draw

K = 30
CFG = dict(reduction_ratio=3, bits=3, s_ratio=0.1, gamp_iters=25, block_size=1591,
           use_kernels=True, gamp_variance_mode="scalar")
SERVER = dict(kind="fedadam", lr=0.003, b1=0.9, b2=0.999, eps=1e-8)
RUNS = [
    ("awgn 20 dB", dict(kind="awgn", snr_db=20.0)),
    ("rayleigh 20 dB", dict(kind="rayleigh", snr_db=20.0)),
    ("mimo_mac lmmse n_rx=8", dict(kind="mimo_mac", n_rx=8)),
    ("mimo_mac zf n_rx=32 csi 0.01",
     dict(kind="mimo_mac", combiner="zf", n_rx=32, csi_error=0.01)),
]


def main():
    (xtr, ytr, _, _), _ = jmnist.load(0)
    parts = jpart(ytr, K, JPart(kind="paper", seed=0))
    params = jmlp.init_mlp(jax.random.PRNGKey(0))
    for label, ch in RUNS:
        t0 = time.time()
        je = jeng.CohortEngine(
            params, jmlp.mlp_grad_fn,
            jeng.ArrayClientData(xtr, ytr, parts, batch_size=1, seed=0),
            fed_cfg=jcomp.FedQCSConfig(**CFG),
            cohort=jeng.CohortConfig(method="fedqcs-ae", seed=0),
            sched=JSched(kind="full", seed=0), chan=JChan(**ch), server=JSrv(**SERVER),
        )
        seen = {}
        ps = je._ps_jit

        def capture(*args, ps=ps, seen=seen):
            out = ps(*args)
            seen["ghat"] = np.asarray(out[0])
            return out

        je._ps_jit = capture
        stats_j = je.run_round()
        p_t, a_t = from_reference({k: np.asarray(v) for k, v in params.items()},
                                  np.asarray(je.codec.a))
        te = teng.CohortEngine(
            p_t, tmlp.mlp_grad_fn,
            teng.ArrayClientData(xtr, ytr, parts, batch_size=1, seed=0, device="cpu"),
            fed_cfg=TCfg(**CFG), cohort=teng.CohortConfig(method="fedqcs-ae", seed=0),
            sched=TSched(kind="full", seed=0), chan=TChan(**ch), server=TSrv(**SERVER),
            device="cpu", a=a_t, draw=reference_draw(0),
        )
        stats_t = te.run_round()
        g_t, g_j = te.last_ghat.numpy(), seen["ghat"]
        row = dict(run=label, participating=(stats_t["participating"],
                                             float(stats_j["participating"])))
        for k in ("nmse", "nu_channel", "nu_quant"):
            row[k + "_port"], row[k + "_ref"] = stats_t[k], float(stats_j[k])
        row["ghat_nmse_port_vs_ref"] = float(np.sum((g_t - g_j) ** 2) / np.sum(g_j**2))
        row["seconds"] = time.time() - t0
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
