"""Batched serving demo on the PyTorch port: prefill a prompt batch, then
greedy-decode (the port's counterpart of ``examples/serve_lm.py``).

    PYTHONPATH=src python examples/serve_lm_torch.py --arch qwen3-moe-235b-a22b \\
        --tokens 24 --device cpu

Runs the prefill -> decode cache handoff for any architecture of the zoo
on its reduced config: ``make_prefill_step`` fills the cache of the
prompt, its self-attention K/V are grown to ``prompt + tokens`` slots
(``model.grow_cache``; an SSM state is O(1) in the sequence and stays as
it is), and ``make_decode_step`` (donating the cache: each step writes its
slot and states in place) decodes greedily from position ``--prompt-len``.
A VLM prompt carries a patch prefix (a quarter of ``--prompt-len``) and
its M-RoPE positions; an audio prompt is ``--prompt-len`` frame
embeddings (Whisper's prefill encodes them and decodes a BOS token).
``--device`` defaults to ``cuda``.
"""

import argparse

import torch

from repro_torch import entry_device, prng
from repro_torch.configs.registry import ARCHS, smoke_config
from repro_torch.launch.mesh import make_single_device_mesh
from repro_torch.models import model as M
from repro_torch.runtime import steps


def prompt_batch(cfg, batch: int, prompt_len: int, seed: int = 1, device="cpu") -> dict:
    """Uniform prompt tokens (a VLM: a patch prefix of prompt_len // 4
    positions, then text, positions 0.. on all three M-RoPE streams; the
    audio family: normal(0, 0.02) frame embeddings), drawn on ``device``
    from ``PRNGKey(seed)`` as the reference's example draws its prompt."""
    key = prng.PRNGKey(seed, device=device)
    if cfg.family == "audio":
        return {"frames": prng.normal(key, (batch, prompt_len, cfg.d_model)) * 0.02}
    sv = prompt_len // 4 if cfg.family == "vlm" else 0
    out = {"tokens": prng.randint(key, (batch, prompt_len - sv), 0, cfg.vocab_size)}
    if sv:
        out["patches"] = prng.normal(key, (batch, sv, cfg.d_model)) * 0.02
        out["positions"] = torch.arange(prompt_len, device=device).expand(
            3, batch, prompt_len).contiguous()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b", choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = entry_device(args.device)
    mesh = make_single_device_mesh()
    cfg = smoke_config(args.arch)
    if not cfg.supports_decode:
        raise SystemExit(f"{args.arch} has no decode step")
    params = M.init_params(cfg, seed=0, device=dev)
    smax = args.prompt_len + args.tokens
    batch = prompt_batch(cfg, args.batch, args.prompt_len, device=dev)

    prefill_fn = steps.make_prefill_step(cfg, mesh)
    decode_fn = steps.make_decode_step(cfg, mesh, donate=True)

    logits, prompt_cache = prefill_fn(params, batch)
    cache = M.grow_cache(prompt_cache, smax)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    outs = [tok]
    for t in range(args.tokens - 1):
        tok, _, cache = decode_fn(params, cache, tok, args.prompt_len + t)
        outs.append(tok)
    seq = torch.cat(outs, dim=1).cpu()
    print(f"{args.arch}: decoded {tuple(seq.shape)} tokens")
    for row in range(min(2, args.batch)):
        print("  sample", row, ":", seq[row, :12].tolist())


if __name__ == "__main__":
    main()
