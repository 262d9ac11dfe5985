"""Detection/segmentation token post-processing: the port's copy
(``paligemma_tpu_torch/postprocess.py``) and the JAX package's module give
the same results on the JAX package's five cases."""
import pytest

import paligemma_tpu.postprocess as jax_post
import paligemma_tpu_torch.postprocess as torch_post


def _single_detection(pp):
    text = "<loc0256><loc0128><loc0768><loc0896> table"
    dets = pp.extract_detections(text)
    assert len(dets) == 1
    d = dets[0]
    assert d.label == "table"
    assert d.box_norm == (0.25, 0.125, 0.75, 0.875)
    assert d.to_absolute(1000, 800) == (125, 200, 875, 600)
    return dets


def _multiple_objects_with_separator(pp):
    text = (
        "<loc0000><loc0000><loc0512><loc0512> chart ; "
        "<loc0512><loc0512><loc1023><loc1023> logo"
    )
    dets = pp.extract_detections(text)
    assert [d.label for d in dets] == ["chart", "logo"]
    assert dets[1].box_norm[0] == 0.5
    return dets


def _segmentation_indices(pp):
    segs = "".join(f"<seg{i:03d}>" for i in range(16))
    text = f"<loc0100><loc0200><loc0300><loc0400>{segs} figure"
    (d,) = pp.extract_detections(text)
    assert d.seg_indices == list(range(16))
    assert d.label == "figure"
    return [d]


def _strip_and_prompts(pp):
    text = "<loc0001><loc0002><loc0003><loc0004> cat"
    assert pp.strip_location_tokens(text) == "cat"
    assert pp.format_detection_prompt("table", "chart") == "detect table ; chart"
    assert pp.format_segmentation_prompt("cat") == "segment cat"
    return [pp.strip_location_tokens(text), pp.format_detection_prompt("table", "chart")]


def _no_detections_in_plain_text(pp):
    assert pp.extract_detections("the total revenue is 42") == []
    return []


CASES = [_single_detection, _multiple_objects_with_separator, _segmentation_indices, _strip_and_prompts,
         _no_detections_in_plain_text]


def _plain(x):
    """Detections as plain tuples, so the two packages' dataclasses compare."""
    return [(d.box_norm, d.label, d.seg_indices) if hasattr(d, "box_norm") else d for d in x]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__.strip("_"))
@pytest.mark.parametrize("pp", [jax_post, torch_post], ids=["jax", "torch"])
def test_postprocess_case(pp, case):
    assert _plain(case(pp)) == _plain(case(jax_post))
