"""The JAX package on the stimulus of `chip_smoke.py` phase 24b: where
`SCALE_JAX_TIME_OK` comes from.

`python tests/rehearse_scale_out.py` (on the CPU; a few minutes, about 3 GB):
the port builds 24b's 128 subframes on the CPU
(`chip_smoke.scale_time_stimulus`: `TimeShardedDlChain` on Cell(100, id 3)
and DlGrant.full(100, 27), through tests/test_time_shard.py's 3-tap channel
and noise, drawn on the host), and the JAX package's
`TimeShardedDlChain.rx` decodes them: the count of TBs whose CRC passes and
whose bits equal those sent is `SCALE_JAX_TIME_OK`.  `--sharded` also runs
the JAX package's `rx_sharded` over 8 virtual CPU devices and checks that
it equals `rx`.  `--port` prints the port's `rx` count on the CPU beside it.

It prints counts, never a time.  Not a test (pytest does not collect it).
"""

import argparse
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from srslte_tpu.parallel import make_mesh  # noqa: E402
from srslte_tpu.parallel.time_shard import TimeShardedDlChain  # noqa: E402
from srslte_tpu.phy.common.params import Cell  # noqa: E402
from srslte_tpu.phy.phch.ra import DlGrant  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sharded", action="store_true")
    ap.add_argument("--port", action="store_true")
    a = ap.parse_args()
    torch.set_num_threads(4)
    chain_t, bits, x = cs.scale_time_stimulus("cpu")
    bits = bits.numpy()
    chain = TimeShardedDlChain(Cell(n_prb=100, id=3, nof_ports=1), DlGrant.full(100, 27))
    out, ok = chain.rx(jnp.asarray(x))
    good = np.asarray(ok) & (np.asarray(out) == bits).all(-1)
    print(f"JAX rx: {int(good.sum())}/{len(good)} TBs, lost "
          f"{tuple(np.flatnonzero(~good).tolist())}", flush=True)
    if a.sharded:
        out_s, ok_s = chain.rx_sharded(jnp.asarray(x), make_mesh({"t": 8}))
        same = (np.array_equal(np.asarray(out_s), np.asarray(out))
                and np.array_equal(np.asarray(ok_s), np.asarray(ok)))
        print(f"JAX rx_sharded over 8 virtual devices equal to rx: {same}", flush=True)
    if a.port:
        t_out, t_ok = chain_t.rx(torch.as_tensor(x))
        t_good = t_ok.numpy() & (t_out.numpy() == bits).all(-1)
        print(f"port rx on the CPU: {int(t_good.sum())}/{len(t_good)} TBs, lost "
              f"{tuple(np.flatnonzero(~t_good).tolist())}", flush=True)
    print(f"SCALE_JAX_TIME_OK = {int(good.sum())}")


if __name__ == "__main__":
    main()
