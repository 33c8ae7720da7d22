"""One rank of tests/test_torch_distributed.py, test_torch_model_parallel.py
and test_torch_sequence_pipeline.py: the port's data, tensor, sequence and
pipeline parallelism on gloo ranks on the CPU, at tiny widths, dropout 0
(but the tensor-parallel DROPOUT_STAGES), one torch thread.

  RANK=r WORLD_SIZE=n MASTER_ADDR=localhost MASTER_PORT=p \\
      python tests/torch_dist_worker.py JOB ROOT

JOB "two" (at 2 ranks) runs the updates of both stages in every mode, the
decodes, cli.diff_norm_synthesis and cli.train; "three" (at 3 ranks)
validates and resumes that cli.train checkpoint. "tp" (2 ranks, data 1 x
model 2) runs the tensor-parallel updates of every TP_STAGES model and the
normalizer's, the NAR's and the MoE layer's runs from JAX's TP states; "dptp" (4 ranks, data 2 x model
2) the NAR and normalizer updates in every mode, the data x tensor decode
and a cli.train checkpoint, which "tp_three" (3 ranks) validates and
resumes; "sp" (4 ranks) the ring attention, the sequence-parallel
conformer and the pipeline on the test's inputs. Rank 0 writes each result
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
DECODE_VOCAB = 24  # the data x tensor decode's NAR (JAX's weights)
# the sequence-parallel conformers (JAX tests/test_sequence_parallel.py's)
SP_ENCODERS = {
    "even": dict(dim=16, ffn_dim=32, layers=2, heads=4, dropout=0.0, depthwise_kernel_size=7,
                 conv_channels=16),
    "ragged": dict(dim=16, ffn_dim=32, layers=1, heads=2, dropout=0.0,
                   depthwise_kernel_size=3, conv_channels=16),
    "grad": dict(dim=16, ffn_dim=32, layers=1, heads=2, dropout=0.0, depthwise_kernel_size=3,
                 conv_channels=16),
}
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


def nar_model(seed: int = 0, dropout: float = 0.0):
    from diffnorm_tpu_torch.models.nar_transformer import NARS2UTModule

    torch.manual_seed(seed)
    return NARS2UTModule(**{**NAR, "dropout": dropout})


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


# the dummy tasks the tensor-parallel updates also train, as cli.train builds
# them (flags of the JAX dryrun's stages)
TASK_ARGV = {
    "vae": ["--task", "dummy_vae", "--feature-dim", "24", "--latent-dim", "3", "--chan-mults",
            "[4]", "--vae-decoder-depth", "1", "--vae-decoder-dim-head", "8",
            "--vae-decoder-heads", "2", "--target-code-size", "16", "--batch-size", "4",
            "--tokens-per-sample", "12"],
    "hubert": ["--task", "dummy_hubert", "--target-code-size", "24", "--conv-feature-layers",
               "[(8,10,5),(8,3,2)]", "--encoder-embed-dim", "16", "--encoder-layers", "1",
               "--encoder-attention-heads", "2", "--encoder-ffn-embed-dim", "32",
               "--final-dim", "8", "--batch-size", "2", "--tokens-per-sample", "800",
               "--attention-dropout", "0", "--activation-dropout", "0"],
}
# the NAR and HuBERT at every dropout rate 0.1: the masks of the sharded
# regions (attention probabilities, the FF inner width) cut from one drawn
# over the whole tensor, so the updates are one process's
DROPOUT_STAGES = {"nar_dropout": "nar", "hubert_dropout": "hubert"}
DROPOUT = 0.1
# normalizer_odd: width 20, so the FF's inner width 53 splits unevenly (27 +
# 26), as the released width's 1365 does
TP_STAGES = ("normalizer", "normalizer_odd", "vae", "nar", "hubert", "moe") + tuple(
    DROPOUT_STAGES)
# the stages whose TP updates start from JAX's state, held to JAX's GSPMD step
JAX_TP_STAGES = ("nar", "moe")
MOE = dict(dim=8, ffn_dim=16, num_experts=4)
MOE_TOKENS = 16


def task_stage(stage: str, dropout: float = 0.0):
    """(model, criterion, batches, frozen keys) of a dummy task: N_UPDATES
    prepared batches (the batches' draws from one seeded generator); every
    dropout rate `dropout`."""
    from diffnorm_tpu_torch.cli import train as train_cli
    from diffnorm_tpu_torch.tasks import TASKS

    rates = ["--attention-dropout", str(dropout), "--activation-dropout", str(dropout)]
    args = train_cli.parse_args(TASK_ARGV[stage] + [
        "--cpu", "--dropout", str(dropout), "--dataset-size", str(N_UPDATES), "--max-update",
        "1"] + (rates if dropout else []))
    torch.manual_seed(0)
    task = TASKS[args.task](args)
    model = task.build_model() if dropout else no_dropout(task.build_model())
    rng = np.random.default_rng(3)
    batches = [task.prepare_batch(dict(b), rng) for b in task.dataset("train")]
    return model, train_cli.build_criterion(task, args), batches, task.frozen_param_keys


class MoEModel(torch.nn.Module):
    def __init__(self):
        super().__init__()
        from diffnorm_tpu_torch.models.moe import BaseLayer

        self.moe = BaseLayer(**MOE)


class MoELoss:
    """The mean squared error of the BASE layer's output against a target
    (a "mean_loss" criterion over global counts)."""

    grad_accum, data_parallel = "mean_loss", True

    def __call__(self, model, batch, generator=None):
        from diffnorm_tpu_torch.parallel.mesh import global_mean

        x = batch["src_tokens"].float()
        y = model.moe(x.reshape(-1, MOE["dim"]))
        loss = global_mean((y - batch["target"].float().reshape(y.shape)).square())
        return loss, {"loss": loss.detach(), "sample_size": 1.0}


def moe_batches(seed: int = 16):
    rng = np.random.default_rng(seed)
    shape = (2, MOE_TOKENS // 2, MOE["dim"])
    return [{"src_tokens": rng.normal(size=shape).astype(np.float32),
             "target": rng.normal(size=shape).astype(np.float32)} for _ in range(N_UPDATES)]


def run_updates(stage: str, mode: str, optimizer: str, mesh: Mesh, setup=None, cfg=None):
    """N_UPDATES float32 updates of `stage` in `mode` with `optimizer`;
    returns (losses, gnorms, {name: master}) (the masters whole) and the
    largest difference of a replicated parameter or buffer between the
    model ranks after the updates. `setup` (model, criterion, batches,
    frozen keys) and `cfg` replace the stage's own."""
    from diffnorm_tpu_torch.train.trainer import Trainer, TrainerConfig

    if setup is None:
        if stage in TASK_ARGV:
            setup = task_stage(stage)
        elif stage == "nar_dropout":
            from diffnorm_tpu_torch.criterions.nar_loss import NARSpeechToUnitLoss

            setup = nar_model(dropout=DROPOUT), NARSpeechToUnitLoss(0.2), nar_batches(), ()
        elif stage in DROPOUT_STAGES:
            setup = task_stage(DROPOUT_STAGES[stage], DROPOUT)
        elif stage == "moe":
            torch.manual_seed(0)
            setup = MoEModel(), MoELoss(), moe_batches(), ()
        elif stage == "normalizer_odd":
            from diffnorm_tpu_torch.criterions.ddpm_loss import DDPMDiscreteLoss
            from diffnorm_tpu_torch.models.diffusion import LatentDiffusionModule

            torch.manual_seed(0)
            setup = (LatentDiffusionModule(**{**DIFF, "dim": 20}), DDPMDiscreteLoss(),
                     normalizer_batches(), ("vae",))
        else:
            setup = stage_setup(stage)
    model, criterion, batches, frozen = setup
    cfg = cfg or TrainerConfig(lr=1e-3, warmup_updates=2, warmup_init_lr=1e-4, seed=5,
                               **MODES[mode], **OPTIMIZERS[optimizer])
    trainer = Trainer(cfg, model, criterion, frozen_keys=frozen, mesh=mesh)
    losses, gnorms = [], []
    for batch in (batches if isinstance(batches[0], list) else [[b] for b in batches]):
        out = trainer.train_step(batch)
        losses.append(out["loss"])
        gnorms.append(out["gnorm"])
    axis, drift = mesh.model_axis, 0.0
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        if name not in trainer.tp_specs and axis.active:
            both = axis.all_gather(t.detach()[None], 0)
            drift = max(drift, (both - both[:1]).abs().max().item())
    with trainer.gathered_master() as master:
        params = {n: p.detach().clone().numpy() for n, p in master.named_parameters()}
        params.update({n: b.detach().clone().numpy() for n, b in master.named_buffers()})
    return np.asarray(losses), np.asarray(gnorms), params, drift


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
                losses, gnorms, params, _ = run_updates(stage, mode, optimizer, mesh)
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


def save_updates(path: Path, mesh: Mesh, result) -> None:
    losses, gnorms, params, drift = result
    if mesh.rank == 0:
        np.savez(path, losses=losses, gnorms=gnorms, drift=drift,
                 **{f"p/{k}": v for k, v in params.items()})


def jax_tp_setup(root: Path):
    """The normalizer from JAX's initial TP state and JAX's micro-batches
    (with their draws injected), written by the test."""
    from diffnorm_tpu_torch.criterions.ddpm_loss import DDPMDiscreteLoss
    from diffnorm_tpu_torch.models.diffusion import LatentDiffusionModule
    from diffnorm_tpu_torch.train.checkpoint import load_variables
    from diffnorm_tpu_torch.weights import from_jax_params

    widths = {k: v for k, v in DIFF.items() if k != "dropout"}
    model = from_jax_params(LatentDiffusionModule(dropout=0.0, **widths),
                            load_variables(str(root / "jax_tp_init.npz"))["params"])
    data = np.load(root / "jax_tp_batches.npz")
    micros = [{k.split("/", 1)[1]: data[k] for k in data.files if k.startswith(f"{i}/")}
              for i in range(int(data["n"]))]
    per = int(data["update_freq"])
    groups = [micros[i:i + per] for i in range(0, len(micros), per)]
    return model, DDPMDiscreteLoss(), groups, ("vae",)


def jax_tp_stage_setup(root: Path, stage: str):
    """The NAR or the MoE layer from JAX's initial TP state, and JAX's
    micro-batch, written by the test."""
    from diffnorm_tpu_torch.criterions.nar_loss import NARSpeechToUnitLoss
    from diffnorm_tpu_torch.train.checkpoint import load_variables
    from diffnorm_tpu_torch.weights import from_jax_variables

    variables = load_variables(str(root / f"jax_tp_{stage}.npz"))
    with np.load(root / f"jax_tp_{stage}_batch.npz") as data:
        batch = {k: data[k] for k in data.files}
    if stage == "nar":
        return from_jax_variables(nar_model(), variables), NARSpeechToUnitLoss(0.2), [batch], ()
    model = MoEModel()
    with torch.no_grad():
        for name, p in model.moe.named_parameters():
            p.copy_(torch.from_numpy(variables["params"][name]))
    return model, MoELoss(), [batch], ()


def job_tp(root: Path, mesh: Mesh) -> None:
    import json

    from diffnorm_tpu_torch.train.trainer import TrainerConfig

    for stage in TP_STAGES:
        save_updates(root / f"tp_{stage}.npz", mesh, run_updates(stage, "replicated", "sgd",
                                                                 mesh))
    save_updates(root / "tp_normalizer_adam.npz", mesh,
                 run_updates("normalizer", "replicated", "adam", mesh))
    cfg = TrainerConfig(**json.loads((root / "jax_tp_cfg.json").read_text()))
    save_updates(root / "tp_jax.npz", mesh,
                 run_updates("normalizer", "replicated", "adam", mesh, jax_tp_setup(root), cfg))
    for stage in JAX_TP_STAGES:
        save_updates(root / f"tp_jax_{stage}.npz", mesh, run_updates(
            stage, "replicated", "sgd", mesh, jax_tp_stage_setup(root, stage), cfg))


def job_dptp(root: Path, mesh: Mesh) -> None:
    from diffnorm_tpu_torch.cli import train as train_cli
    from diffnorm_tpu_torch.cli import validate
    from diffnorm_tpu_torch.generate.mask_predict import mask_predict_decode
    from diffnorm_tpu_torch.models.nar_transformer import NARS2UTModule
    from diffnorm_tpu_torch.parallel.sharding_rules import shard_model
    from diffnorm_tpu_torch.train.checkpoint import load_variables
    from diffnorm_tpu_torch.weights import from_jax_variables

    for mode in MODES:
        save_updates(root / f"dptp_nar_{mode}.npz", mesh, run_updates("nar", mode, "sgd", mesh))
    save_updates(root / "dptp_normalizer_fsdp.npz", mesh,
                 run_updates("normalizer", "fsdp", "sgd", mesh))
    model = from_jax_variables(NARS2UTModule(**{**NAR, "vocab_size": DECODE_VOCAB}),
                               load_variables(str(root / "decode_nar.npz"))).eval()
    shard_model(model, mesh.model_axis)
    data = np.load(root / "decode_in.npz")
    with torch.no_grad():
        tokens, scores, steps = mask_predict_decode(
            model, torch.from_numpy(data["src"]), torch.from_numpy(data["lengths"]),
            mesh=mesh, **DECODE)
    if mesh.rank == 0:
        np.savez(root / "dptp_decode.npz", tokens=tokens.numpy(), scores=scores.numpy(),
                 steps=steps.numpy())
    train_cli.main(CLI_TRAIN + ["--max-update", "2", "--save-dir", str(root / "tpckpt"),
                                "--data-parallel", "2", "--model-parallel", "2"])
    vals = validate.validate(validate.parse_args(validate_argv(root, "tpckpt") + [
        "--data-parallel", "2", "--model-parallel", "2"]))
    if mesh.rank == 0:
        (root / "tp_valid_dptp.txt").write_text(repr(vals["loss"]))


def job_tp_three(root: Path, mesh: Mesh) -> None:
    """The data 2 x model 2 checkpoint validated and resumed at 3 ranks."""
    import shutil

    from diffnorm_tpu_torch.cli import train as train_cli
    from diffnorm_tpu_torch.cli import validate

    vals = validate.validate(validate.parse_args(validate_argv(root, "tpckpt")))
    if mesh.index == 0:
        (root / "tp_valid3.txt").write_text(repr(vals["loss"]))
        shutil.copytree(root / "tpckpt", root / "tpckpt3")
    mesh.barrier()
    train_cli.main(CLI_TRAIN + ["--max-update", "3", "--save-dir", str(root / "tpckpt3")])


def job_sp(root: Path, mesh: Mesh) -> None:
    """The sequence-parallel and pipeline functions on the test's inputs
    (SP_CASES), each output and gradient saved by rank 0."""
    from diffnorm_tpu_torch.models.conformer import ConformerEncoder
    from diffnorm_tpu_torch.parallel.mesh import make_seq_mesh, make_stage_mesh
    from diffnorm_tpu_torch.parallel.pipeline import pipeline_apply
    from diffnorm_tpu_torch.parallel.sequence import (
        conformer_encode_sp,
        sequence_parallel_attention,
    )
    from diffnorm_tpu_torch.train.checkpoint import load_variables
    from diffnorm_tpu_torch.weights import from_jax_variables

    data = np.load(root / "sp_in.npz")
    seq, out = make_seq_mesh(4), {}

    def t(key, grad=False, dtype=torch.float32):
        return torch.tensor(data[key], dtype=dtype, requires_grad=grad)

    for case, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        q, k, v = (t(f"{n}_{case}", dtype=dtype) for n in "qkv")
        mask = torch.from_numpy(data["mask"])
        out[f"attn_{case}"] = sequence_parallel_attention(q, k, v, mask, seq).float()
    out["attn_nomask"] = sequence_parallel_attention(*(t(f"{n}_f32") for n in "qkv"),
                                                     None, seq)
    q, k, v = (t(f"{n}_g", grad=True) for n in "qkv")
    grads = torch.autograd.grad((sequence_parallel_attention(q, k, v, torch.from_numpy(
        data["mask_g"]), seq) ** 2).sum(), (q, k, v))
    out.update({f"attn_grad_{n}": g for n, g in zip("qkv", grads)})
    for case in ("even", "ragged", "grad"):
        enc = ConformerEncoder(**SP_ENCODERS[case]).eval()
        from_jax_variables(enc, load_variables(str(root / f"sp_enc_{case}.npz")))
        src, lens = t(f"src_{case}"), torch.from_numpy(data[f"lens_{case}"])
        if case != "grad":
            with torch.no_grad():
                out[f"enc_{case}"], out[f"mask_{case}"] = conformer_encode_sp(enc, src, lens, seq)
            continue
        enc_out, enc_mask = conformer_encode_sp(enc, src, lens, seq)
        names = [n for n, _ in enc.named_parameters()]
        grads = torch.autograd.grad(((enc_out * enc_mask[..., None]) ** 2).sum(),
                                    list(enc.parameters()))
        out.update({f"enc_grad/{n}": g for n, g in zip(names, grads)})
    stages = make_stage_mesh(4)
    w = t("pp_w")[stages.index].clone().requires_grad_()
    b = t("pp_b")[stages.index].clone().requires_grad_()
    x = t("pp_x", grad=True)
    pp = pipeline_apply(lambda p, h: torch.tanh(h @ p["w"] + p["b"]), {"w": w, "b": b}, x,
                        stages)
    gw, gb, gx = torch.autograd.grad((pp ** 2).sum(), (w, b, x))
    out["pp"], out["pp_grad_x"] = pp, gx
    out["pp_grad_w"], out["pp_grad_b"] = (stages.all_gather(g.detach()[None], 0)
                                          for g in (gw, gb))
    if seq.index == 0:
        np.savez(root / "sp_out.npz", **{k: v.detach().float().numpy() for k, v in out.items()})


def validate_argv(root: Path, ckpt: str = "ckpt"):
    keep = [a for a in CLI_TRAIN if a not in ("--fsdp",)]
    i = keep.index("--zero-sharding")
    del keep[i:i + 2]
    i = keep.index("--lr")
    del keep[i:]
    return keep + ["--seed", "3", "--path", str(root / ckpt / "step_000000002")]


def main() -> int:
    import torch.distributed as dist

    from diffnorm_tpu_torch.parallel.mesh import init_distributed, make_mesh

    torch.set_num_threads(1)
    job, root = sys.argv[1], Path(sys.argv[2])
    init_distributed(cpu=True, timeout_s=120)
    mesh = make_mesh(model=2 if job in ("tp", "dptp") else 1)
    {"two": job_two, "three": job_three, "tp": job_tp, "dptp": job_dptp,
     "tp_three": job_tp_three, "sp": job_sp}[job](root, mesh)
    dist.destroy_process_group()
    print(f"RANK_OK {mesh.rank}", flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main())
