"""The multi-process dryrun: every parallel path of the port at tiny widths
(the port's counterpart of the JAX repo's `dryrun_multichip`).

  python -m diffnorm_tpu_torch.cli.dryrun_multichip --ranks 4 --cpu

spawns N ranks (gloo on the CPU with --cpu, NCCL on a card a rank
otherwise), each running the stages in order on a data x model layout of
2-way tensor parallelism where N is even (data N / 2), data alone where it
is odd:

  0  the NAR S2UT conformer's update, data x tensor parallel, --fsdp
  1  the speech VAE's update, data x tensor parallel
  2  the normalizer's update with its VAE frozen, --fsdp on the 2-D layout
  3  a checkpoint of stage 2 written (whole), restored, and one more update
  4  the code-HiFi-GAN D + G step, data parallel over uneven row blocks,
     its losses and generator held to one process
  5  a GPipe pipeline over min(4, N) stages
  6  the sequence-parallel conformer encode over min(4, N) ranks, held to
     the unsharded encoder
  7  wav2vec2's pretraining update, data x tensor parallel
  8  DDIM normalization with its rows over N data-parallel ranks, units
     equal to one process; the mask-predict decode on the data x tensor
     layout, tokens equal to one process
  9  `s2st_generate` with its rows over N ranks, units and lengths equal to
     one process
  10 HuBERT's pretraining update, data x tensor parallel

Every loss must be finite and every pin hold. Rank 0 ends with the summary
line; a rank that fails stops every rank, and the command exits non-zero.
"""

from __future__ import annotations

import argparse
import math
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional, Sequence

RANK_ENV = "DIFFNORM_DRYRUN_ROOT"
NAR_FLAGS = ["--task", "dummy_nar", "--arch", "nar_s2ut_conformer", "--criterion",
             "nar_speech_to_unit", "--label-smoothing", "0.2", "--encoder-layers", "2",
             "--decoder-layers", "2", "--encoder-embed-dim", "32", "--encoder-ffn-embed-dim",
             "64", "--encoder-attention-heads", "2", "--decoder-attention-heads", "2",
             "--decoder-embed-dim", "32", "--decoder-ffn-embed-dim", "64", "--conv-channels",
             "32", "--depthwise-conv-kernel-size", "7", "--target-code-size", "32", "--lr",
             "5e-4", "--warmup-updates", "10000"]
VAE_FLAGS = ["--task", "dummy_vae", "--feature-dim", "24", "--latent-dim", "3", "--chan-mults",
             "[4]", "--vae-decoder-depth", "1", "--vae-decoder-dim-head", "8",
             "--vae-decoder-heads", "2", "--target-code-size", "16", "--lr", "1e-3",
             "--warmup-updates", "10"]
W2V_FLAGS = ["--task", "dummy_wav2vec2", "--conv-feature-layers", "[(8,10,5),(8,3,2)]",
             "--encoder-embed-dim", "16", "--encoder-layers", "1", "--encoder-attention-heads",
             "2", "--encoder-ffn-embed-dim", "32", "--final-dim", "8", "--latent-vars", "6",
             "--latent-groups", "2", "--num-negatives", "4", "--lr", "1e-4",
             "--warmup-updates", "10"]
HUBERT_FLAGS = ["--task", "dummy_hubert", "--target-code-size", "24", "--conv-feature-layers",
                "[(8,10,5),(8,3,2)]", "--encoder-embed-dim", "16", "--encoder-layers", "1",
                "--encoder-attention-heads", "2", "--encoder-ffn-embed-dim", "32",
                "--final-dim", "8", "--lr", "1e-3", "--warmup-updates", "10"]
DIFF = dict(dim=16, latent_dim=3, feature_dim=24, vocab_size=20, timesteps=20,
            denoiser_depth=1, wavenet_layers=2, wavenet_stacks=1, vae_decoder_depth=1,
            vae_decoder_dim_head=8, vae_decoder_heads=2, chan_mults=[4])


# the data-parallel GAN step against one process on the whole batch: float32
# sums in other orders (the generator's parameters after a step of lr 1e-4
# within 1e-6, 1% of a step)
GAN_RTOL, GAN_ATOL, GAN_PARAM_ATOL = 1e-5, 1e-6, 1e-6


def _finite(value: float, what: str) -> float:
    if not math.isfinite(value):
        raise AssertionError(f"{what}: loss {value} is not finite")
    return value


def _task(flags: Sequence[str], cpu: bool, rows: int, tokens: int):
    """(task, model, criterion, trainer config, one prepared batch) of a
    dummy task built as cli.train builds it."""
    import numpy as np
    import torch

    from diffnorm_tpu_torch.cli import train as train_cli
    from diffnorm_tpu_torch.tasks import TASKS

    args = train_cli.parse_args(list(flags) + [
        "--batch-size", str(rows), "--tokens-per-sample", str(tokens), "--dataset-size", "1",
        "--max-update", "1"] + (["--cpu"] if cpu else []))
    torch.manual_seed(0)
    task = TASKS[args.task](args)
    model = task.build_model()
    batch = task.prepare_batch(dict(task.dataset("train")[0]), np.random.default_rng(0))
    return task, model, train_cli.build_criterion(task, args), train_cli.trainer_config(args), \
        batch


def _update(flags, cpu, rows, tokens, mesh, device, **cfg_kw) -> float:
    import dataclasses

    from diffnorm_tpu_torch.train.trainer import Trainer

    task, model, criterion, cfg, batch = _task(flags, cpu, rows, tokens)
    trainer = Trainer(dataclasses.replace(cfg, **cfg_kw), model.to(device), criterion,
                      frozen_keys=task.frozen_param_keys, mesh=mesh)
    return trainer.train_step([batch])["loss"]


def run_rank(root: Path, cpu: bool) -> int:
    import numpy as np
    import torch

    from diffnorm_tpu_torch.criterions.ddpm_loss import DDPMDiscreteLoss
    from diffnorm_tpu_torch.generate.mask_predict import mask_predict_decode
    from diffnorm_tpu_torch.generate.s2st import s2st_generate
    from diffnorm_tpu_torch.models.conformer import ConformerEncoder
    from diffnorm_tpu_torch.models.diffusion import LatentDiffusionModule, ddim_sample
    from diffnorm_tpu_torch.models.hifigan import CodeGenerator
    from diffnorm_tpu_torch.parallel.mesh import (
        init_distributed,
        make_mesh,
        make_seq_mesh,
        make_stage_mesh,
        world_size,
    )
    from diffnorm_tpu_torch.parallel.pipeline import pipeline_apply
    from diffnorm_tpu_torch.parallel.sequence import conformer_encode_sp
    from diffnorm_tpu_torch.parallel.sharding_rules import shard_model
    from diffnorm_tpu_torch.train.checkpoint import CheckpointManager
    from diffnorm_tpu_torch.train.gan_trainer import GanTrainer
    from diffnorm_tpu_torch.train.trainer import Trainer, TrainerConfig
    from diffnorm_tpu_torch.weights import from_jax_variables

    device = init_distributed(cpu=cpu)
    n = world_size()
    model_par = 2 if n % 2 == 0 else 1
    dp = n // model_par
    mesh = make_mesh(dp, model_par)
    main = mesh.rank == 0
    t0 = time.time()

    def mark(stage: str) -> None:
        if main:
            print(f"[dryrun +{time.time() - t0:6.1f}s] {stage}", flush=True)

    rows = max(2, dp)
    mark("start: NAR DP x TP + FSDP train step")
    nar_loss = _finite(_update(NAR_FLAGS, cpu, rows, 32, mesh, device, fsdp=True), "NAR")

    mark("stage 1: VAE train step")
    vae_loss = _finite(_update(VAE_FLAGS, cpu, rows, 16, mesh, device), "VAE")

    mark("stage 2: diffusion train step (frozen VAE, FSDP+TP)")
    _, _, _, _, vae_batch = _task(VAE_FLAGS, cpu, rows, 16)
    diff_cfg = TrainerConfig(lr=1e-4, warmup_updates=10, fsdp=True)

    def diffusion():
        torch.manual_seed(4)
        with torch.device(device):
            return LatentDiffusionModule(**DIFF)

    diff_trainer = Trainer(diff_cfg, diffusion(), DDPMDiscreteLoss(), ("vae",), mesh=mesh)
    diff_loss = _finite(diff_trainer.train_step([vae_batch])["loss"], "diffusion")

    mark("stage 3: sharded checkpoint round trip")
    ckpt = CheckpointManager(str(root / "ckpt"), keep_last=1)
    with diff_trainer.gathered_master() as master:
        state = diff_trainer.state_dict()
        if main:
            ckpt.save(1, master, state, None, {"epoch": 1})
    mesh.barrier()
    variables, state, _ = ckpt.load(1, device)
    restored = Trainer(diff_cfg, from_jax_variables(diffusion(), variables), DDPMDiscreteLoss(),
                       ("vae",), mesh=mesh)
    restored.load_state_dict(state)
    post_loss = _finite(restored.train_step([vae_batch])["loss"], "diffusion after restore")

    mark("stage 4: GAN vocoder D+G step")
    g_rng = np.random.default_rng(0)
    gan_rows = rows + 1  # uneven row blocks where the data degree is above 1
    gan_batch = {"code": g_rng.integers(0, 8, size=(gan_rows, 16)).astype(np.int64),
                 "wav": (g_rng.normal(size=(gan_rows, 16 * 8)) * 0.1).astype(np.float32),
                 "durations": g_rng.integers(-1, 4, size=(gan_rows, 16))}
    gan_batch["durations"][gan_batch["durations"] < 0] = -100  # ignored durations

    def gan_step(m):
        torch.manual_seed(7)
        with torch.device(device):
            gen = CodeGenerator(num_embeddings=8, embedding_dim=8, upsample_rates=(4, 2),
                                upsample_kernel_sizes=(8, 4), upsample_initial_channel=16,
                                resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),),
                                dur_predictor=True)
        gan = GanTrainer(gen, dict(lr=1e-4, n_fft=64, hop_size=32, win_size=64, num_mels=20,
                                   mpd_periods=(2, 3), msd_scales=2, disc_width=0.0625),
                         device, mesh=m)
        mets = gan.train_step(gan_batch)
        return mets, torch.cat([p.detach().reshape(-1) for p in gen.parameters()])

    (gan_mets, gen_params), (one_mets, one_params) = gan_step(mesh), gan_step(None)
    for key, ref in one_mets.items():
        _finite(gan_mets[key], f"GAN {key}")
        if abs(gan_mets[key] - ref) > GAN_RTOL * abs(ref) + GAN_ATOL:
            raise AssertionError(f"GAN {key}: {gan_mets[key]} against {ref} in one process")
    gan_err = (gen_params - one_params).abs().max().item()
    if gan_err > GAN_PARAM_ATOL:
        raise AssertionError(f"the GAN step's generator differs from one process's by {gan_err}")

    mark("stage 5: GPipe pipeline")
    pp = min(4, n)
    stages = make_stage_mesh(pp)
    if stages.active or pp == 1:
        w = torch.full((8, 8), 0.1, device=device)
        out = pipeline_apply(lambda p, h: torch.tanh(h @ p["w"]), {"w": w},
                             torch.ones(4, 2, 8, device=device), stages)
        ref = torch.ones(4, 2, 8, device=device)
        for _ in range(pp):
            ref = torch.tanh(ref @ w)
        if not torch.isfinite(out).all() or (out - ref).abs().max() > 1e-5:
            raise AssertionError("the pipeline's output differs from the stages in turn")

    mark("stage 6: sequence-parallel conformer encode")
    sp_n = min(4, n)
    seq = make_seq_mesh(sp_n)
    if seq.active or sp_n == 1:
        torch.manual_seed(8)
        with torch.device(device):
            enc = ConformerEncoder(dim=16, ffn_dim=32, layers=1, heads=2, dropout=0.0,
                                   depthwise_kernel_size=3, conv_channels=16).eval()
        rng = np.random.default_rng(0)
        src = torch.tensor(rng.normal(size=(2, 16 * sp_n, 80)), dtype=torch.float32,
                           device=device)
        lens = torch.tensor([16 * sp_n, 9], device=device)
        with torch.no_grad():
            sp_out, sp_mask = conformer_encode_sp(enc, src, lens, seq)
            ref, _ = enc(src, lens)
        err = ((sp_out - ref) * sp_mask[..., None]).abs().max().item()
        if not torch.isfinite(sp_out).all() or err > 5e-5:
            raise AssertionError(f"the SP conformer differs from the unsharded one by {err}")

    mark("stage 7: wav2vec2 contrastive pretrain step")
    w2v_loss = _finite(_update(W2V_FLAGS, cpu, rows, 800, mesh, device), "wav2vec2")

    mark("stage 8: dp-sharded ddim_sample + dpxtp mask-predict decode")
    dp_mesh = make_mesh(n, 1)
    d_rng = np.random.default_rng(0)
    feat = torch.tensor(d_rng.normal(size=(n, 12, 24)), dtype=torch.float32, device=device)
    lens = d_rng.integers(6, 13, size=n)
    d_mask = torch.tensor(np.arange(12)[None, :] < lens[:, None], device=device)
    ddim_model = diffusion().eval()
    units = [ddim_sample(ddim_model, feat, d_mask, start_step=6, device=device, mesh=m,
                         generator=torch.Generator(device=device).manual_seed(12))[0]
             for m in (dp_mesh, None)]
    if not torch.equal(units[0], units[1]):
        raise AssertionError("dp-sharded ddim_sample diverged from single-device units")
    task, _, _, _, nar_batch = _task(NAR_FLAGS, cpu, n, 32)
    src = torch.as_tensor(nar_batch["src_tokens"], device=device)
    src_lengths = torch.as_tensor(nar_batch["src_lengths"], device=device)

    def nar_model():
        torch.manual_seed(13)
        with torch.device(device):
            return task.build_model().eval()

    one = nar_model()
    sharded = nar_model()
    shard_model(sharded, mesh.model_axis)
    with torch.no_grad():
        t1 = mask_predict_decode(one, src, src_lengths, max_iter=3, max_len=16)[0]
        t8 = mask_predict_decode(sharded, src, src_lengths, max_iter=3, max_len=16,
                                 mesh=mesh)[0]
    if not torch.equal(t1, t8):
        raise AssertionError("dpxtp mask-predict decode diverged from single-device tokens")

    mark("stage 9: dp-sharded fused s2st_generate")
    torch.manual_seed(14)
    with torch.device(device):
        voc = CodeGenerator(num_embeddings=36, embedding_dim=8, upsample_rates=(4, 2),
                            upsample_kernel_sizes=(8, 4), upsample_initial_channel=16,
                            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),),
                            dur_predictor=True).eval()
    with torch.no_grad():
        got = [s2st_generate(one, voc, src, src_lengths, max_iter=2, max_len=16, max_duration=4,
                             vocoder_chunk=0, mesh=m) for m in (dp_mesh, None)]
    wav8, wl8, su8, _ = got[0]
    wav1, wl1, su1, _ = got[1]
    if not (torch.equal(su8, su1) and torch.equal(wl8, wl1)
            and torch.allclose(wav8, wav1, rtol=2e-4, atol=2e-4)):
        raise AssertionError("dp-sharded s2st_generate diverged from the one-process run")

    mark("stage 10: HuBERT masked-prediction pretrain step")
    hub_loss = _finite(_update(HUBERT_FLAGS, cpu, rows, 800, mesh, device), "HuBERT")

    if main:
        print(f"dryrun_multichip ok: {n} ranks (dp={dp} x tp={model_par}, fsdp on, "
              f"pp={pp}-stage, sp={sp_n}-way ring, inference dp+dpxtp pinned) | "
              f"nar loss={nar_loss:.4f} vae loss={vae_loss:.4f} diff loss={diff_loss:.4f} "
              f"diff-post-restore loss={post_loss:.4f} gan d={gan_mets['loss_d']:.4f} "
              f"g={gan_mets['loss_g']:.4f} w2v loss={w2v_loss:.4f} "
              f"hubert loss={hub_loss:.4f}", flush=True)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(ranks: int, cpu: bool, timeout_s: float) -> int:
    """Start `ranks` processes of this module; rank 0's output goes to
    stdout, each other's to a log that is printed if it fails."""
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        procs: List = []
        for r in range(ranks):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(ranks),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), **{RANK_ENV: tmp})
            if cpu:
                env.setdefault("OMP_NUM_THREADS", "1")
            log = None if r == 0 else open(root / f"rank{r}.log", "w")
            cmd = [sys.executable, "-m", "diffnorm_tpu_torch.cli.dryrun_multichip",
                   "--ranks", str(ranks)] + (["--cpu"] if cpu else [])
            procs.append((subprocess.Popen(cmd, env=env, stdout=log,
                                           stderr=subprocess.STDOUT if log else None), log))
        start, failed = time.time(), None
        try:
            while any(p.poll() is None for p, _ in procs):
                failed = next((r for r, (p, _) in enumerate(procs)
                               if p.poll() not in (None, 0)), None)
                if failed is not None or time.time() - start > timeout_s:
                    break
                time.sleep(0.1)
            failed = next((r for r, (p, _) in enumerate(procs) if p.poll() not in (None, 0)),
                          failed)
            timed_out = any(p.poll() is None for p, _ in procs)
        finally:
            for p, log in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
                if log is not None:
                    log.close()
        if failed is not None or timed_out:
            which = failed if failed is not None else 0
            if which:
                print((root / f"rank{which}.log").read_text()[-4000:], file=sys.stderr)
            print(f"dryrun_multichip failed: rank {which} "
                  f"{'timed out' if failed is None else 'failed'} after "
                  f"{time.time() - start:.0f} s", file=sys.stderr)
            return 1
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=4, help="processes to spawn")
    p.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU")
    p.add_argument("--timeout", type=float, default=600.0,
                   help="seconds before every rank is stopped")
    args = p.parse_args(argv)
    if os.environ.get(RANK_ENV):
        return run_rank(Path(os.environ[RANK_ENV]), args.cpu)
    if not args.cpu:
        from diffnorm_tpu_torch.device import resolve_device

        resolve_device("cuda")  # raises without a card, before any rank starts
    return spawn(args.ranks, args.cpu, args.timeout)


if __name__ == "__main__":
    sys.exit(main())
