"""Rank body of tests/test_torch_dist.py's two-process ``gloo`` run.

Each rank joins a ``file://`` process group, runs every distributed
scenario of the port on the CPU and saves what it computed to
``<out_dir>/rank<r>.pt``; the test process compares the ranks with the
single-process port and with the reference.  It imports torch and
``repro_torch`` only, so a spawned rank starts without JAX.

Scenarios (inputs from ``in_path``, written by the test process):
  * ``pod``: ``fedqcs_pod_allreduce`` on this pod's blocks and residual, for
    the kernel and plain routes x (gather_codes AE, gather_codes EA,
    psum_dequant AE);
  * ``dead``: the same with pod 1 dead, once with garbage blocks and once
    with zeros (the dead-pod contracts);
  * ``ea_psum_error``: the text EA + psum_dequant raises;
  * ``steps``: three ``impl="shard_map"`` steps of the smoke model, each
    from the single-process ``impl="auto"`` state before it (this pod's
    residual row);
  * ``chunked``: the chunked EA decode with its chunks shared over a
    two-rank ``recon`` axis.
"""

import dataclasses


def run(rank: int, world: int, init_file: str, in_path: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.core import recon_engine
    from repro_torch.core.compression import BQCSCodec
    from repro_torch.core.reconstruction import gamp_config_from
    from repro_torch.launch.mesh import Mesh, make_debug_mesh
    from repro_torch.runtime import steps
    from repro_torch.runtime.collectives import fedqcs_pod_allreduce

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        inp = torch.load(in_path, weights_only=False)  # written by the test process
        fed, a = inp["fed"], inp["a"]
        blocks, resid = inp["blocks"][rank], inp["resid"][rank]
        out = {"pod": {}, "dead": {}}
        for kernels in (False, True):
            for wire, mode in (("gather_codes", "ae"), ("gather_codes", "ea"),
                               ("psum_dequant", "ae")):
                cfg = dataclasses.replace(fed, use_kernels=kernels, wire_mode=wire,
                                          recon_mode=mode)
                codec = BQCSCodec(cfg, a=a, device="cpu")
                out["pod"][(kernels, wire, mode)] = fedqcs_pod_allreduce(blocks, resid, codec)
        codec = BQCSCodec(fed, a=a, device="cpu")
        part = torch.tensor([1.0, 0.0])
        for name, dead_blocks in (("garbage", inp["garbage"]), ("zeros", torch.zeros_like(blocks))):
            mine = blocks if rank == 0 else dead_blocks
            out["dead"][name] = fedqcs_pod_allreduce(mine, resid, codec,
                                                     participating=part[rank])
        try:
            cfg = dataclasses.replace(fed, recon_mode="ea", wire_mode="psum_dequant")
            fedqcs_pod_allreduce(blocks, resid, BQCSCodec(cfg, a=a, device="cpu"))
            out["ea_psum_error"] = None
        except ValueError as e:
            out["ea_psum_error"] = str(e)

        step_fn = steps.make_train_step(inp["model_cfg"], inp["opt"], fed,
                                        make_debug_mesh(world), impl="shard_map",
                                        device="cpu", a=a)
        out["steps"] = []
        for state, batch in zip(inp["auto_states"], inp["batches"]):
            local = dict(state, residual=state["residual"][rank:rank + 1])
            new, metrics = step_fn(local, batch)
            out["steps"].append({"loss": metrics["loss"], "residual": new["residual"],
                                 "params": new["params"] if rank == 0 else None})

        ea = BQCSCodec(dataclasses.replace(fed, recon_mode="ea"), a=a, device="cpu")
        words, alpha = inp["words"], inp["alpha"]
        rhos = torch.full((words.shape[0],), 1.0 / words.shape[0])
        out["chunked"] = recon_engine.ea_decode(
            ea, words, alpha, rhos, gamp_config_from(ea), packed=True, chunk=3,
            mesh=Mesh({"recon": world}))
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
