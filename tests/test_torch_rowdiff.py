"""``utils/rowdiff.first_row_difference`` on the CPU: it names the first
operation at which a row of a batched call parts from the same row of a
smaller call, a ``fns`` kernel call included, and finds nothing where no
operation mixes rows."""
import pytest
import torch

import paligemma_tpu_torch
from paligemma_tpu_torch import serving
from paligemma_tpu_torch.models import gemma, paligemma
from paligemma_tpu_torch.ops.kernels import PLAIN
from paligemma_tpu_torch.utils import rowdiff


def _inputs(batch, width=6):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((4, 5, width), generator=gen)
    return x[torch.arange(batch) % 4]  # row 0 is the same in every batch


def test_a_row_mixing_op_is_named_and_row_wise_ops_are_not():
    w = torch.randn((6, 6), generator=torch.Generator().manual_seed(4))

    def run(fns, batch):
        y = torch.relu(_inputs(batch) @ w)
        y = y - y.mean(dim=0)  # mixes the rows
        return y * 2.0

    diff = rowdiff.first_row_difference(run, 1, 8, PLAIN)
    assert diff["op"] == "aten.mean" and diff["differing"] > 0 and diff["inputs"] == [(8, 5, 6)], diff
    assert rowdiff.first_row_difference(lambda fns, b: torch.relu(_inputs(b) @ w) * 2.0, 1, 8, PLAIN) is None


def test_a_kernel_call_is_compared_as_one_operation():
    """A ``fns`` call whose output mixes rows is named ``fns.<field>``; the
    ATen operations inside it are not recorded."""
    def mixing_flash(q, k, v, *args, **kwargs):
        return PLAIN.flash(q, k, v, *args, **kwargs) + q.mean(dim=0, keepdim=True)

    fns = PLAIN._replace(flash=mixing_flash)

    def run(fns, batch):
        q = _inputs(batch, 8).reshape(batch, 5, 2, 4)
        return fns.flash(q, q[:, :, :1], q[:, :, :1]) * 3.0

    diff = rowdiff.first_row_difference(run, 1, 4, fns)
    assert diff["op"] == "fns.flash", diff
    assert rowdiff.first_row_difference(run, 1, 4, PLAIN) is None


def test_mismatched_batches_raise():
    with pytest.raises(ValueError, match="multiple"):
        rowdiff.first_row_difference(lambda fns, b: None, 2, 3)


def test_tiny_join_prefill_row_labels_and_verdict():
    """The batched prefill of a tiny fp32 model at group batch 1 and 4, row
    0 the same request: every operation is labelled by its layer, and where
    row 0 parts (if it does) it is not at a kernel of the bundle."""
    cfg = paligemma_tpu_torch.tiny_config()
    model = paligemma.init_params(cfg, 0, device="cpu", dtype=torch.float32)
    n_img, size = cfg.vision_config.num_image_tokens, cfg.vision_config.image_size
    gen = torch.Generator().manual_seed(5)
    ids = torch.randint(3, cfg.text_config.vocab_size, (4, n_img + 9), generator=gen, dtype=torch.int32)
    ids[:, :n_img] = cfg.image_token_index
    pix = torch.randn((4, 3, size, size), generator=gen)
    valid = torch.tensor([n_img + 9, n_img + 4, n_img + 7, n_img + 2], dtype=torch.int32)
    seen = set()

    def run(fns, batch):
        cache = gemma.init_cache(cfg.text_config, batch, ids.shape[1], torch.float32, "cpu")
        return serving.batched_prefill(model, ids[:batch], pix[:batch], valid[:batch], cache, fns)[0]

    labels = rowdiff.model_labels(model)
    diff = rowdiff.first_row_difference(run, 1, 4, PLAIN, labels)
    assert diff is None or not diff["op"].startswith("fns."), diff

    rec = rowdiff._Recorder(lambda op, where, outs, ins: seen.add((op, where)))
    hooks = rec.label(labels)
    with torch.no_grad(), rec:
        run(rec.wrap(PLAIN), 1)
    for h in hooks:
        h.remove()
    assert ("fns.flash", "siglip layer 0") in seen and ("fns.flash", "gemma layer 1") in seen
    assert any(w == "gemma final_norm" for _, w in seen)
