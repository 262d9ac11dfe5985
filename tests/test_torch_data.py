"""The port's financial dataset (``paligemma_tpu_torch/data.py``) against the
JAX package's (``paligemma_tpu/data.py``) on a parquet the test writes:
every sample equal array by array (tokenization, labels, pixels, the
corrupt and missing rows' fall-forward, the all-unusable white fallback),
the validation report, the image glob and the batches (static shapes,
ragged tail dropped, the same order under a seed)."""
import numpy as np
import pandas as pd
import pytest
from PIL import Image

from paligemma_tpu import data as jdata
from paligemma_tpu.processing import ByteTokenizer as JByteTokenizer
from paligemma_tpu_torch import data as tdata
from paligemma_tpu_torch.processing import ByteTokenizer


def _rows(n):
    return [{"source_identifier": f"doc{i}", "FEATURE_page_indexes": [i % 2],
             "FEATURE_full_prompt": f"what is the total of item {i} on page {i % 2}?", "template_id": "t1"}
            for i in range(n)]


@pytest.fixture
def dataset_dir(tmp_path):
    images = tmp_path / "images"
    images.mkdir()
    rng = np.random.RandomState(0)
    rows = _rows(5)
    for i, row in enumerate(rows):
        Image.fromarray(rng.randint(0, 255, (40 + 3 * i, 30, 3), np.uint8)).save(
            images / f"{row['source_identifier']}_p{i % 2}.png")
    rows.append({"source_identifier": "missing", "FEATURE_page_indexes": [0],
                 "FEATURE_full_prompt": "missing image", "template_id": "t1"})
    (images / "corrupt_p0.png").write_bytes(b"not an image")
    rows.append({"source_identifier": "corrupt", "FEATURE_page_indexes": [0],
                 "FEATURE_full_prompt": "corrupt image " * 12, "template_id": "t1"})
    parquet = tmp_path / "data.parquet"
    pd.DataFrame(rows).to_parquet(parquet)
    return str(parquet), str(images)


def _tokenizers():
    out = []
    for cls in (JByteTokenizer, ByteTokenizer):
        tok = cls()
        tok.add_special_tokens({"additional_special_tokens": ["<image>"]})
        out.append(tok)
    return out


def _datasets(parquet, images, **kw):
    jt, tt = _tokenizers()
    return (jdata.FinancialImageDataset(parquet, images, jt, **kw),
            tdata.FinancialImageDataset(parquet, images, tt, **kw))


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_columns_glob_and_validation_match(dataset_dir):
    parquet, images = dataset_dir
    assert tdata.REQUIRED_COLUMNS == jdata.REQUIRED_COLUMNS
    for sid, page in (("doc0", 0), ("doc1", 1), ("doc1", 0), ("nope", 0)):
        assert tdata.find_page_image(images, sid, page) == jdata.find_page_image(images, sid, page)
    quiet = lambda *_: None  # noqa: E731
    report = tdata.validate_dataset(parquet, images, max_check=100, logger=quiet)
    assert report == jdata.validate_dataset(parquet, images, max_check=100, logger=quiet)
    assert report == {"checked": 7, "missing": 1, "corrupted": 1}
    pd.DataFrame({"source_identifier": ["a"]}).to_parquet(parquet)
    with pytest.raises(ValueError, match="FEATURE_page_indexes"):
        tdata.validate_dataset(parquet, images, logger=quiet)


@pytest.mark.parametrize("max_length", [20, 64])
def test_samples_equal_jax_array_by_array(dataset_dir, max_length):
    """Every row (the missing and corrupt ones fall forward to the next
    usable image), truncated (20) and padded (64)."""
    parquet, images = dataset_dir
    jd, td = _datasets(parquet, images, num_image_tokens=4, image_size=16, max_length=max_length)
    assert len(td) == len(jd) == 7
    for i in range(len(td)):
        _same(jd[i], td[i])
    s = td[0]
    assert np.all(s["labels"][:4] == -100) and np.all(s["labels"][s["valid_len"]:] == -100)
    np.testing.assert_array_equal(s["labels"][4: s["valid_len"]], s["input_ids"][4: s["valid_len"]])


def test_all_images_unusable_gives_a_white_image(tmp_path):
    (tmp_path / "images").mkdir()
    pd.DataFrame(_rows(2)).to_parquet(tmp_path / "d.parquet")
    jd, td = _datasets(str(tmp_path / "d.parquet"), str(tmp_path / "images"), num_image_tokens=2,
                       image_size=8, max_length=32)
    _same(jd[1], td[1])
    assert np.all(td[1]["pixel_values"] == 1.0)  # white, normalized to [-1, 1]


def test_max_length_must_leave_room_for_text(dataset_dir):
    parquet, images = dataset_dir
    with pytest.raises(ValueError, match="must exceed"):
        tdata.FinancialImageDataset(parquet, images, _tokenizers()[1], num_image_tokens=8, max_length=10)


def test_batches_equal_jax(dataset_dir):
    """5 samples at batch 2: two static-shape batches, the tail dropped,
    in the order JAX's seeded shuffle gives, over two epochs."""
    parquet, images = dataset_dir
    jd, td = _datasets(parquet, images, num_image_tokens=2, image_size=8, max_length=32, max_samples=5)
    jb = list(jd.batches(batch_size=2, shuffle=True, seed=1, epochs=2))
    tb = list(td.batches(batch_size=2, shuffle=True, seed=1, epochs=2))
    assert len(tb) == len(jb) == 4
    for a, b in zip(jb, tb):
        _same(a, b)
        assert b["input_ids"].shape == (2, 32) and b["pixel_values"].shape == (2, 3, 8, 8)
