"""LM evaluation CLI (the port of diffnorm_tpu/cli/eval_lm.py; reference
fairseq_cli/eval_lm.py): the per-token NLL and perplexity of a unit LM over
a split.

  python -m diffnorm_tpu_torch.cli.eval_lm $DATA --task language_modeling \\
      --arch transformer_lm --path ckpt/lm/step_000001000 --gen-subset test \\
      [--max-tokens 8192] [--batch-size N] [--tokens-per-sample 1024]

It takes cli.train's model, data and task flags (`--task` sedd_lm by
default, as JAX's, or sedd, unit_lm, language_modeling: each reads the same
unit manifests; `--arch` transformer_lm by default); `--path` is a step
directory or a weights.save_npz file. Each batch is scored as the
targets shifted right behind an EOS, positions equal to PAD (1) left out,
in the unshuffled order of --max-tokens / --batch-size batches. Runs on the
GPU (in --dtype) unless --cpu is given. Prints JAX's last line, `Loss
(nats): L, Perplexity: P`.
"""

from __future__ import annotations

import logging
import math
import sys
from typing import Optional, Sequence, Tuple

import torch

from diffnorm_tpu_torch.cli import train as train_cli
from diffnorm_tpu_torch.data.iterators import EpochBatchIterator
from diffnorm_tpu_torch.device import resolve_device
from diffnorm_tpu_torch.tasks import TASKS
from diffnorm_tpu_torch.train.checkpoint import load_variables
from diffnorm_tpu_torch.utils.compile_cache import enable_compile_cache
from diffnorm_tpu_torch.weights import from_jax_variables

logger = logging.getLogger("diffnorm_tpu_torch.eval_lm")

PAD, EOS = 1, 2


def parse_args(argv: Optional[Sequence[str]] = None):
    pre = train_cli.preparse(argv)
    p = train_cli.build_parser(__doc__.split("\n")[0], train=False, task="sedd_lm")
    p.add_argument("--path", required=True,
                   help="the checkpoint: a step directory or a weights.save_npz file")
    p.add_argument("--gen-subset", default="test")
    p.set_defaults(arch="transformer_lm", max_tokens=8192)
    train_cli.apply_config(p, pre.config)
    return train_cli.check_args(p, p.parse_args(argv))


@torch.no_grad()
def nll(model, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(summed NLL, scored positions) of `tokens` [B, T] as next-token
    targets behind an EOS, PAD positions left out."""
    prev = torch.cat([torch.full_like(tokens[:, :1], EOS), tokens[:, :-1]], dim=1)
    lp = torch.log_softmax(model(prev).float(), dim=-1)
    token_nll = -lp.gather(-1, tokens[..., None])[..., 0]
    keep = tokens != PAD
    return torch.where(keep, token_nll, 0.0).sum(), keep.sum()


def evaluate(args) -> Tuple[float, int]:
    """(the mean NLL in nats, the tokens scored) of --path over --gen-subset."""
    device = resolve_device("cpu" if args.cpu else "cuda")
    task = TASKS[args.task](args)
    with torch.device(device):
        model = task.build_model()
    from_jax_variables(model, load_variables(args.path))
    model = model.to(getattr(torch, args.dtype)).eval()
    logger.info("restored %s", args.path)
    total_nll, total_tokens = 0.0, 0
    for batch in EpochBatchIterator(task.dataset(args.gen_subset), args.max_tokens,
                                    shuffle=False, max_sentences=args.batch_size,
                                    num_prefetch=0).next_epoch_itr():
        s, n = nll(model, torch.from_numpy(batch["target_unit"]).long().to(device))
        total_nll += float(s)
        total_tokens += int(n)
    avg = total_nll / max(total_tokens, 1)
    logger.info("Evaluated %d tokens: loss %.4f nats, ppl %.2f", total_tokens, avg,
                math.exp(avg))
    return avg, total_tokens


def main(argv: Optional[Sequence[str]] = None) -> int:
    enable_compile_cache()
    logging.basicConfig(level=logging.INFO, force=True,
                        format="%(asctime)s | %(levelname)s | %(message)s")
    avg, _ = evaluate(parse_args(argv))
    print(f"Loss (nats): {avg:.4f}, Perplexity: {math.exp(avg):.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
