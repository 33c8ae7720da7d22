"""One rank of tests/test_torch_distributed.py: the port's data parallelism
on gloo ranks on the CPU, at tiny widths, dropout 0, one torch thread.

  RANK=r WORLD_SIZE=n MASTER_ADDR=localhost MASTER_PORT=p \\
      python tests/torch_dist_worker.py JOB ROOT

JOB "two" (at 2 ranks) runs the updates of both stages in every mode, the
decodes, cli.diff_norm_synthesis and cli.train; "three" (at 3 ranks)
validates and resumes that cli.train checkpoint. Rank 0 writes each result
under ROOT. The model and batch builders are also the test's one-process
references.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from diffnorm_tpu_torch.parallel.mesh import Mesh  # noqa: E402

FEAT, LATENT, CODES, T = 24, 3, 16, 9
DIFF = dict(dim=16, latent_dim=LATENT, feature_dim=FEAT, vocab_size=CODES + 4, timesteps=50,
            denoiser_depth=1, wavenet_layers=2, wavenet_stacks=1, vae_decoder_depth=1,
            vae_decoder_dim_head=8, vae_decoder_heads=2, chan_mults=[4], dropout=0.0)
NAR = dict(vocab_size=CODES + 4, in_channels=80, encoder_dim=32, encoder_ffn_dim=64,
           encoder_layers=1, encoder_heads=2, decoder_dim=32, decoder_ffn_dim=64,
           decoder_layers=1, decoder_heads=2, depthwise_kernel_size=7, conv_channels=32,
           dropout=0.0)
VOCODER = dict(num_embeddings=CODES, embedding_dim=8, upsample_rates=(4, 2),
               upsample_kernel_sizes=(8, 4), upsample_initial_channel=16,
               resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 2),),
               dur_predictor=True, var_pred_hidden_dim=16)
MODES = {"replicated": {}, "zero": {"zero_sharding": "os"}, "fsdp": {"fsdp": True}}
# sgd with momentum carries a rounding difference of the gradient sums into
# the masters as it is; Adam divides each gradient by its own root mean
# square, so where a gradient is 0 in exact arithmetic (the keys' biases,
# which softmax ignores) its rounding becomes a step of about lr
OPTIMIZERS = {"sgd": {"optimizer": "sgd", "options": {"momentum": 0.9}},
              "adam": {"optimizer": "adam"}}
NORM_ROWS, NAR_ROWS = 5, 4  # the normalizer's 5 rows split 3 + 2 over 2 ranks
# SEDD's and FastSpeech2's "mean_loss" criterions (global counts), and the
# stages every mode and optimizer runs
EXTRA_STAGES = ("sedd", "fastspeech2")
FULL_STAGES = ("normalizer", "nar")
N_UPDATES = 2
DECODE = dict(max_iter=3, max_len=16)
CLI_TRAIN = ["--task", "dummy_vae", "--cpu", "--feature-dim", "24", "--latent-dim", "3",
             "--chan-mults", "[4]", "--vae-decoder-depth", "1", "--vae-decoder-dim-head", "8",
             "--vae-decoder-heads", "2", "--target-code-size", "16", "--dropout", "0",
             "--batch-size", "6", "--tokens-per-sample", "12", "--dataset-size", "2",
             "--lr", "1e-3", "--warmup-updates", "2", "--log-interval", "1", "--seed", "3",
             "--fsdp", "--zero-sharding", "os", "--ema-decay", "0.9", "--use-bmuf",
             "--global-sync-iter", "2"]


def normalizer(seed: int = 0):
    from diffnorm_tpu_torch.models.diffusion import LatentDiffusionModule

    torch.manual_seed(seed)
    return LatentDiffusionModule(**DIFF)


def nar_model(seed: int = 0):
    from diffnorm_tpu_torch.models.nar_transformer import NARS2UTModule

    torch.manual_seed(seed)
    return NARS2UTModule(**NAR)


def vocoder(seed: int = 1):
    from diffnorm_tpu_torch.models.hifigan import CodeGenerator

    torch.manual_seed(seed)
    return CodeGenerator(**VOCODER).eval()


def normalizer_batches(seed: int = 11):
    """N_UPDATES batches of NORM_ROWS rows, ragged, 0-padded units."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(N_UPDATES):
        lengths = rng.integers(T // 2, T + 1, size=NORM_ROWS).astype(np.int32)
        mask = np.arange(T)[None, :] < lengths[:, None]
        feat = (rng.normal(size=(NORM_ROWS, T, FEAT)) * mask[..., None]).astype(np.float32)
        units = np.where(mask, rng.integers(4, CODES + 4, size=(NORM_ROWS, T)), 0)
        out.append({"reduce_target": feat, "reduce_target_unit": units.astype(np.int32),
                    "reduce_target_lengths": lengths})
    return out


def nar_batches(seed: int = 12, frames: int = 24, units: int = 7):
    """N_UPDATES NAR batches: fbank sources, unit targets (pad 1) and CMLM
    canvases (unk 3 at the masked positions)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(N_UPDATES):
        src_lengths = rng.integers(frames // 2, frames + 1, size=NAR_ROWS).astype(np.int64)
        src = rng.normal(size=(NAR_ROWS, frames, 80)).astype(np.float32)
        src *= (np.arange(frames)[None, :] < src_lengths[:, None])[..., None]
        tgt_lengths = rng.integers(3, units + 1, size=NAR_ROWS)
        valid = np.arange(units)[None, :] < tgt_lengths[:, None]
        target = np.where(valid, rng.integers(4, CODES + 4, size=(NAR_ROWS, units)), 1)
        masked = valid & (rng.random((NAR_ROWS, units)) < 0.5)
        masked[:, 0] |= valid[:, 0]
        prev = np.where(masked, 3, target)
        out.append({"src_tokens": src, "src_lengths": src_lengths,
                    "target": target.astype(np.int64), "prev_target": prev.astype(np.int64)})
    return out


def sedd_batches(seed: int = 14, rows: int = 5, t: int = 12):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(N_UPDATES):
        lengths = rng.integers(t // 2, t + 1, size=rows).astype(np.int64)
        tokens = np.where(np.arange(t)[None, :] < lengths[:, None],
                          rng.integers(4, CODES + 4, size=(rows, t)), 1)
        out.append({"target_unit": tokens.astype(np.int64), "target_lengths": lengths})
    return out


def fastspeech2_batches(seed: int = 15, rows: int = 5, s: int = 6, mels: int = 8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(N_UPDATES):
        n_src = rng.integers(3, s + 1, size=rows)
        valid = np.arange(s)[None, :] < n_src[:, None]
        tokens = np.where(valid, rng.integers(4, CODES + 4, size=(rows, s)), 1)
        durations = np.where(valid, rng.integers(1, 4, size=(rows, s)), 0)
        frames = durations.sum(1)
        out.append({"src_tokens": tokens.astype(np.int64),
                    "durations": durations.astype(np.int64),
                    "pitches": (rng.normal(size=(rows, s)) * valid).astype(np.float32),
                    "energies": (rng.normal(size=(rows, s)) * valid).astype(np.float32),
                    "feat_tgt": rng.normal(size=(rows, int(frames.max()), mels)).astype(np.float32),
                    "tgt_lengths": frames.astype(np.int64)})
    return out


def no_dropout(model):
    """`model` with every dropout rate 0 (SEDD's transformer fixes 0.1):
    dropout is rank-local, so the comparisons run without it."""
    for m in model.modules():
        if isinstance(getattr(m, "p", None), float):
            m.p = 0.0
        if isinstance(getattr(m, "dropout", None), float):
            m.dropout = 0.0
    return model


def stage_setup(stage: str):
    """(model, criterion, batches, frozen keys) of a stage."""
    from diffnorm_tpu_torch.criterions.ddpm_loss import DDPMDiscreteLoss
    from diffnorm_tpu_torch.criterions.nar_loss import NARSpeechToUnitLoss
    from diffnorm_tpu_torch.criterions.sedd_loss import SEDDLoss
    from diffnorm_tpu_torch.criterions.tts_loss import FastSpeech2Loss
    from diffnorm_tpu_torch.models.fastspeech2 import FastSpeech2Module
    from diffnorm_tpu_torch.models.sedd import SEDDModule

    if stage == "normalizer":
        return normalizer(), DDPMDiscreteLoss(), normalizer_batches(), ("vae",)
    if stage == "nar":
        return nar_model(), NARSpeechToUnitLoss(0.2), nar_batches(), ()
    torch.manual_seed(0)
    if stage == "sedd":
        return (no_dropout(SEDDModule(CODES + 4, dim=32, depth=1, heads=2)), SEDDLoss(),
                sedd_batches(), ())
    model = FastSpeech2Module(CODES + 4, dim=16, ffn_dim=32, encoder_layers=1,
                              decoder_layers=1, heads=2, n_mels=8, max_frames=24, var_hidden=16,
                              dropout=0.0)
    return model, FastSpeech2Loss(), fastspeech2_batches(), ()


def run_updates(stage: str, mode: str, optimizer: str, mesh: Mesh):
    """N_UPDATES float32 updates of `stage` ("normalizer" or "nar") in
    `mode` with `optimizer`; returns (losses, gnorms, {name: master}) (the
    masters whole)."""
    from diffnorm_tpu_torch.train.trainer import Trainer, TrainerConfig

    model, criterion, batches, frozen = stage_setup(stage)
    cfg = TrainerConfig(lr=1e-3, warmup_updates=2, warmup_init_lr=1e-4, seed=5,
                        **MODES[mode], **OPTIMIZERS[optimizer])
    trainer = Trainer(cfg, model, criterion, frozen_keys=frozen, mesh=mesh)
    losses, gnorms = [], []
    for batch in batches:
        out = trainer.train_step([batch])
        losses.append(out["loss"])
        gnorms.append(out["gnorm"])
    with trainer.gathered_master() as master:
        params = {n: p.detach().clone().numpy() for n, p in master.named_parameters()}
        params.update({n: b.detach().clone().numpy() for n, b in master.named_buffers()})
    return np.asarray(losses), np.asarray(gnorms), params


def decode_inputs(seed: int = 13, b: int = 5, frames: int = 24):
    rng = np.random.default_rng(seed)
    lengths = np.sort(rng.integers(frames // 2, frames + 1, size=b))[::-1].astype(np.int64)
    src = rng.normal(size=(b, frames, 80)).astype(np.float32)
    src *= (np.arange(frames)[None, :] < lengths[:, None])[..., None]
    return torch.from_numpy(src), torch.from_numpy(lengths.copy())


def run_decodes(mesh: Mesh):
    """mask_predict_decode and s2st_generate (their outputs, in order)."""
    from diffnorm_tpu_torch.generate.mask_predict import mask_predict_decode
    from diffnorm_tpu_torch.generate.s2st import s2st_generate

    model, voc = nar_model().eval(), vocoder()
    with torch.no_grad():  # varied units from random weights (chip_smoke.py's seeded_nar)
        emb = model.decoder.embed_tokens.weight
        emb[:4] = 0.0
        emb[4:] *= 10.0
    src, lengths = decode_inputs()
    tokens, scores, steps = mask_predict_decode(model, src, lengths, length_beam=2, mesh=mesh,
                                                **DECODE)
    wav, wav_lengths, units, counts = s2st_generate(model, voc, src, lengths, max_duration=4,
                                                    vocoder_chunk=0, mesh=mesh, **DECODE)
    return {"tokens": tokens.numpy(), "scores": scores.numpy(), "steps": steps.numpy(),
            "wav": wav.numpy(), "wav_lengths": wav_lengths.numpy(), "units": units.numpy(),
            "counts": counts.numpy()}


def run_ddim(root: Path, mesh: Mesh):
    from diffnorm_tpu_torch.models.diffusion import LatentDiffusionModule, ddim_sample
    from diffnorm_tpu_torch.train.checkpoint import load_variables
    from diffnorm_tpu_torch.weights import from_jax_variables

    data = np.load(root / "ddim_in.npz")
    widths = {k: v for k, v in DIFF.items() if k != "dropout"}
    model = from_jax_variables(LatentDiffusionModule(**widths),
                               load_variables(str(root / "ddim_params.npz"))).eval()
    units, recon = ddim_sample(
        model, torch.from_numpy(data["feature"]), torch.from_numpy(data["mask"]),
        start_step=int(data["start_step"]), enc_noise=torch.from_numpy(data["enc_noise"]),
        init_noise=torch.from_numpy(data["init_noise"]), device="cpu", mesh=mesh)
    return {"units": units.numpy(), "recon": recon.numpy()}


def job_two(root: Path, mesh: Mesh) -> None:
    from diffnorm_tpu_torch.cli import diff_norm_synthesis
    from diffnorm_tpu_torch.cli import train as train_cli

    for stage in FULL_STAGES + EXTRA_STAGES:
        for mode in (MODES if stage in FULL_STAGES else ("replicated",)):
            for optimizer in (OPTIMIZERS if stage in FULL_STAGES else ("sgd",)):
                losses, gnorms, params = run_updates(stage, mode, optimizer, mesh)
                if mesh.index == 0:
                    np.savez(root / f"{stage}_{mode}_{optimizer}.npz", losses=losses,
                             gnorms=gnorms, **{f"p/{k}": v for k, v in params.items()})
    decodes = run_decodes(mesh)
    ddim = run_ddim(root, mesh)
    if mesh.index == 0:
        np.savez(root / "decode.npz", **decodes)
        np.savez(root / "ddim.npz", **ddim)
    diff_norm_synthesis.main((root / "synth_args.txt").read_text().split()
                             + ["--output-dir", str(root / "synth_dp"), "--data-parallel", "2"])
    train_cli.main(CLI_TRAIN + ["--max-update", "2", "--save-dir", str(root / "ckpt")])


def job_three(root: Path, mesh: Mesh) -> None:
    """The 2-rank checkpoint: validated at 3 ranks, and resumed for one more
    update at 3 ranks (its sharded optimizer state sliced three ways)."""
    import shutil

    from diffnorm_tpu_torch.cli import train as train_cli
    from diffnorm_tpu_torch.cli import validate

    args = validate.parse_args(validate_argv(root))
    vals = validate.validate(args)
    if mesh.index == 0:
        (root / "valid3.txt").write_text(repr(vals["loss"]))
        shutil.copytree(root / "ckpt", root / "ckpt3")
    mesh.barrier()
    train_cli.main(CLI_TRAIN + ["--max-update", "3", "--save-dir", str(root / "ckpt3")])


def validate_argv(root: Path):
    keep = [a for a in CLI_TRAIN if a not in ("--fsdp",)]
    i = keep.index("--zero-sharding")
    del keep[i:i + 2]
    i = keep.index("--lr")
    del keep[i:]
    return keep + ["--seed", "3", "--path", str(root / "ckpt" / "step_000000002")]


def main() -> int:
    import torch.distributed as dist

    from diffnorm_tpu_torch.parallel.mesh import init_distributed, make_mesh

    torch.set_num_threads(1)
    job, root = sys.argv[1], Path(sys.argv[2])
    init_distributed(cpu=True, timeout_s=120)
    mesh = make_mesh()
    {"two": job_two, "three": job_three}[job](root, mesh)
    dist.destroy_process_group()
    print(f"RANK_OK {mesh.index}", flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main())
