"""Checkpoint IO (port of ``paligemma_tpu/utils/checkpoint.py``): HF
safetensors shards -> the port's ``PaliGemma``, and the JAX package's own
flat parameter file in both directions.

- The safetensors format is read and written here, without the
  ``safetensors`` package: a u64 little-endian header length, a JSON header
  (per tensor its dtype, shape and ``data_offsets`` into the data), then
  the raw little-endian bytes. A tensor is read through ``np.memmap`` and
  ``torch.frombuffer`` (pages load when touched); BF16 and F16 are read as
  16-bit words and viewed as the torch dtype. An unknown dtype raises;
  nothing is cast silently.
- HF keys map straight to the port's ``state_dict`` names
  (``hf_to_state_dict``). HF stores ``nn.Linear`` weights (out, in), the
  port's layout, so nothing is transposed: q/k/v and gate/up are
  concatenated along dim 0, the patch conv (D, C, P, P) becomes
  ``weight.reshape(D, -1)``, and ``lm_head.weight`` is dropped (the head is
  tied to the token embedding).
- ``load_model`` builds the model on the card (``device="cuda"``) unless
  the caller asks for the CPU. ``streaming=True`` reads, converts and
  copies to the device one parameter at a time, so peak host memory is one
  parameter group, not the checkpoint.
- ``save_params`` / ``load_params`` write and read the JAX package's file:
  one flat safetensors file in its pytree layout (layers stacked (L, ...),
  dense kernels (in, out)), bf16 stored as f32 and listed in a ``.json``
  manifest beside it, so a file moves between the packages either way.
"""
from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from paligemma_tpu_torch.config import PaliGemmaConfig
from paligemma_tpu_torch.models.paligemma import PaliGemma, empty_model
from paligemma_tpu_torch.quantization import Q4Linear, QLinear, W4A8Linear
from paligemma_tpu_torch.utils.convert import from_jax_params

# safetensors dtype names <-> torch dtypes. Every dtype is stored little-endian.
DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}
# 16-bit floats are read as 16-bit words, then viewed as the float type.
_WORDS = {torch.bfloat16: np.uint16, torch.float16: np.uint16}
_NP = {
    torch.float64: np.float64, torch.float32: np.float32, torch.int64: np.int64,
    torch.int32: np.int32, torch.int16: np.int16, torch.int8: np.int8, torch.uint8: np.uint8,
    torch.bool: np.bool_,
}


# ---------------------------------------------------------------------------
# The safetensors format
# ---------------------------------------------------------------------------


def _read_header(path: str) -> Tuple[Dict[str, dict], int]:
    """(the tensors' header entries, the byte offset of the data)."""
    with open(path, "rb") as f:
        (n,) = np.frombuffer(f.read(8), dtype="<u8")
        header = json.loads(f.read(int(n)))
    header.pop("__metadata__", None)
    return header, 8 + int(n)


def _read_tensor(path: str, entry: dict, data_start: int) -> torch.Tensor:
    """One tensor of a safetensors file, memory-mapped (copy on write: the
    file is never changed), as a CPU tensor of its stored dtype."""
    name = entry["dtype"]
    if name not in DTYPES:
        raise ValueError(f"{path}: unsupported safetensors dtype {name!r}")
    dtype, shape = DTYPES[name], tuple(entry["shape"])
    begin, end = entry["data_offsets"]
    np_dtype = np.dtype(_WORDS.get(dtype, _NP.get(dtype))).newbyteorder("<")
    if end - begin != int(np.prod(shape, dtype=np.int64)) * np_dtype.itemsize:
        raise ValueError(f"{path}: {end - begin} bytes for a {name} tensor of shape {shape}")
    if end == begin:
        return torch.empty(shape, dtype=dtype)
    words = np.memmap(path, dtype=np_dtype, mode="c", offset=data_start + begin, shape=(end - begin) // np_dtype.itemsize)
    t = torch.from_numpy(words) if dtype in _WORDS else torch.frombuffer(words, dtype=dtype)
    return t.view(dtype).reshape(shape)


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one safetensors file (memory-mapped CPU tensors)."""
    header, start = _read_header(path)
    return {k: _read_tensor(path, e, start) for k, e in header.items()}


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> int:
    """Write ``tensors`` (any device; copied to the host one at a time) as one
    safetensors file, in the order given; returns the bytes written."""
    header, offset = {}, 0
    for k, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"save_file: {k} has dtype {t.dtype}, which safetensors does not name")
        n = t.numel() * t.element_size()
        header[k] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    if metadata:
        header["__metadata__"] = dict(metadata)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(np.array([len(raw)], dtype="<u8").tobytes())
        f.write(raw)
        for t in tensors.values():
            if t.numel():
                f.write(t.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8).numpy().data)
    return 8 + len(raw) + offset


def _shards(model_path: str):
    files = sorted(Path(model_path).glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors shards under {model_path}")
    return files


def load_safetensors_shards(model_path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of every ``*.safetensors`` shard, in one flat dict."""
    flat: Dict[str, torch.Tensor] = {}
    for f in _shards(model_path):
        flat.update(load_file(str(f)))
    return flat


class LazyShardDict:
    """Dict-like view over ``*.safetensors`` shards that reads a tensor when
    it is asked for (the streaming load: a tensor's pages are read when the
    mapper touches them and dropped with it), with optional renaming."""

    def __init__(self, model_path: str, rename: Optional[Dict[str, str]] = None):
        self._where: Dict[str, Tuple[str, dict, int]] = {}
        for f in _shards(model_path):
            header, start = _read_header(str(f))
            for key, entry in header.items():
                self._where[key] = (str(f), entry, start)
        if rename:
            self._where = {rename.get(k, k): v for k, v in self._where.items()}

    def keys(self):
        return self._where.keys()

    def __iter__(self):
        return iter(self._where)

    def __contains__(self, key) -> bool:
        return key in self._where

    def __getitem__(self, key: str) -> torch.Tensor:
        return _read_tensor(*self._where[key])


# ---------------------------------------------------------------------------
# HF keys -> the port's state_dict
# ---------------------------------------------------------------------------


def hf_key_map(keys) -> Dict[str, str]:
    """old-key -> normalized-key mapping to the hub layout this loader targets.

    google/paligemma-3b-pt-224 (and transformers<=4.51 save_pretrained) use
    ``language_model.model.layers...`` / ``vision_tower...``; transformers'
    refactored models may save ``model.language_model.layers...``. Remap the
    latter to the former. Empty mapping when already normalized.
    """
    keys = list(keys)
    if "language_model.model.embed_tokens.weight" in keys:
        return {}
    if not any(k.startswith("model.") for k in keys):
        return {}
    out = {}
    for k in keys:
        if k.startswith("model.language_model."):
            out[k] = "language_model.model." + k[len("model.language_model."):]
        elif k.startswith("model."):
            out[k] = k[len("model."):]
        elif k == "lm_head.weight":
            out[k] = "language_model.lm_head.weight"
    return out


def normalize_hf_keys(flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Apply ``hf_key_map`` to a materialized flat dict."""
    kmap = hf_key_map(flat.keys())
    if not kmap:
        return flat
    return {kmap.get(k, k): v for k, v in flat.items()}


_VP, _LP = "vision_tower.vision_model", "language_model.model"


def _hf_layout(cfg: PaliGemmaConfig) -> Iterator[Tuple[str, Tuple[str, ...]]]:
    """(port name, the HF keys it is made of), one parameter at a time, in
    the model's order. Several keys are concatenated along dim 0 (q/k/v,
    gate/up); the patch conv is flattened to (D, C*P*P)."""
    vl, tl = cfg.vision_config.num_hidden_layers, cfg.text_config.num_hidden_layers
    yield "vision.patch_embedding.weight", (f"{_VP}.embeddings.patch_embedding.weight",)
    yield "vision.patch_embedding.bias", (f"{_VP}.embeddings.patch_embedding.bias",)
    yield "vision.position_embedding", (f"{_VP}.embeddings.position_embedding.weight",)
    for i in range(vl):
        src, dst = f"{_VP}.encoder.layers.{i}", f"vision.layers.{i}"
        for p in ("weight", "bias"):
            yield f"{dst}.ln1.{p}", (f"{src}.layer_norm1.{p}",)
            yield f"{dst}.qkv.{p}", tuple(f"{src}.self_attn.{n}_proj.{p}" for n in "qkv")
            yield f"{dst}.o.{p}", (f"{src}.self_attn.out_proj.{p}",)
            yield f"{dst}.ln2.{p}", (f"{src}.layer_norm2.{p}",)
            yield f"{dst}.fc1.{p}", (f"{src}.mlp.fc1.{p}",)
            yield f"{dst}.fc2.{p}", (f"{src}.mlp.fc2.{p}",)
    for p in ("weight", "bias"):
        yield f"vision.post_layernorm.{p}", (f"{_VP}.post_layernorm.{p}",)
        yield f"projector.{p}", (f"multi_modal_projector.linear.{p}",)
    yield "llm.embed", (f"{_LP}.embed_tokens.weight",)
    for i in range(tl):
        src, dst = f"{_LP}.layers.{i}", f"llm.layers.{i}"
        yield f"{dst}.input_ln.weight", (f"{src}.input_layernorm.weight",)
        yield f"{dst}.qkv.weight", tuple(f"{src}.self_attn.{n}_proj.weight" for n in "qkv")
        yield f"{dst}.o.weight", (f"{src}.self_attn.o_proj.weight",)
        yield f"{dst}.post_ln.weight", (f"{src}.post_attention_layernorm.weight",)
        yield f"{dst}.gate_up.weight", (f"{src}.mlp.gate_proj.weight", f"{src}.mlp.up_proj.weight")
        yield f"{dst}.down.weight", (f"{src}.mlp.down_proj.weight",)
    yield "llm.final_norm.weight", (f"{_LP}.norm.weight",)


def _build_param(flat, keys: Tuple[str, ...]) -> torch.Tensor:
    """The port's tensor from its HF keys (read from ``flat`` now)."""
    if len(keys) > 1:
        return torch.cat([flat[k] for k in keys], dim=0)
    t = flat[keys[0]]
    return t.reshape(t.shape[0], -1) if keys[0].endswith("patch_embedding.weight") else t


def hf_to_state_dict(flat, cfg: PaliGemmaConfig) -> Dict[str, torch.Tensor]:
    """A flat HF PaliGemma state dict (old- or new-style keys, or a
    ``LazyShardDict``) -> the port's ``state_dict``, in the stored dtype
    (``utils/convert.py::state_dict_from_jax`` gives the same names)."""
    if not isinstance(flat, LazyShardDict):
        flat = normalize_hf_keys(flat)
    return {name: _build_param(flat, keys) for name, keys in _hf_layout(cfg)}


def state_dict_to_hf(model: PaliGemma) -> Iterator[Tuple[str, torch.Tensor]]:
    """The inverse of ``hf_to_state_dict``: (HF key, tensor) of a float
    model in the hub layout, one at a time (views of the model's
    parameters; the fused q/k/v and gate/up split back along dim 0)."""
    vc, tc = model.cfg.vision_config, model.cfg.text_config
    sd = model.state_dict()
    for name, keys in _hf_layout(model.cfg):
        t = sd[name]
        if name == "vision.patch_embedding.weight":
            t = t.reshape(t.shape[0], vc.num_channels, vc.patch_size, vc.patch_size)
        if len(keys) == 1:
            yield keys[0], t
            continue
        if name.startswith("vision."):
            sizes = [vc.hidden_size] * 3
        elif len(keys) == 3:
            sizes = [tc.num_attention_heads * tc.head_dim] + [tc.num_key_value_heads * tc.head_dim] * 2
        else:
            sizes = [tc.intermediate_size] * 2
        yield from zip(keys, t.split(sizes, dim=0))


def _check_float(model: nn.Module, what: str) -> None:
    for name, mod in model.named_modules():
        if isinstance(mod, (QLinear, Q4Linear, W4A8Linear)):
            raise TypeError(
                f"{what} cannot serialize the quantized module at '{name}' "
                f"({type(mod).__name__}): save the unquantized model and "
                "re-quantize after load (quantize_params is deterministic)"
            )


def config_dict(cfg: PaliGemmaConfig) -> dict:
    """``cfg`` as an HF ``config.json`` dict that ``PaliGemmaConfig.from_dict``
    reads back to ``cfg``."""
    vision = {k: v for k, v in dataclasses.asdict(cfg.vision_config).items() if k != "projection_dim"}
    text = {k: v for k, v in dataclasses.asdict(cfg.text_config).items()
            if k not in ("pad_token_id", "num_image_tokens")}
    return {
        "model_type": "paligemma", "architectures": ["PaliGemmaForConditionalGeneration"],
        "vision_config": vision, "text_config": text, "ignore_index": cfg.ignore_index,
        "image_token_index": cfg.image_token_index, "projection_dim": cfg.projection_dim,
        "hidden_size": cfg.hidden_size, "pad_token_id": cfg.pad_token_id,
    }


def save_hf_checkpoint(model: PaliGemma, path: str, max_shard_bytes: int = 2 << 30) -> int:
    """Write a float model as HF-layout safetensors shards
    (``model-0000i-of-0000n.safetensors``, keys in the hub's old style) with
    its ``config.json``, as ``save_pretrained`` lays them out; returns the
    bytes written. Each shard's tensors are copied to the host as it is
    written."""
    _check_float(model, "save_hf_checkpoint")
    os.makedirs(path, exist_ok=True)
    shards, cur, size = [], {}, 0
    for key, t in state_dict_to_hf(model):
        n = t.numel() * t.element_size()
        if cur and size + n > max_shard_bytes:
            shards.append(cur)
            cur, size = {}, 0
        cur[key], size = t, size + n
    shards.append(cur)
    written, index = 0, {}
    for i, shard in enumerate(shards):
        name = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        written += save_file(shard, os.path.join(path, name), {"format": "pt"})
        index.update({k: name for k in shard})
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": written}, "weight_map": index}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config_dict(model.cfg), f, indent=2)
    return written


@torch.no_grad()
def load_model(
    model_path: str,
    dtype: torch.dtype = torch.bfloat16,
    streaming: bool = False,
    device="cuda",
) -> Tuple[PaliGemma, PaliGemmaConfig]:
    """``config.json`` + safetensors shards -> (model on ``device`` in
    ``dtype``, config). The analog of the reference's ``load_hf_model``
    minus the tokenizer (pass an HF ``AutoTokenizer`` into the
    ``PaliGemmaProcessor`` when its assets are at hand).

    ``streaming=True`` reads each tensor when its parameter is built and
    copies it to the device at once, so peak host memory is one parameter
    group (a fused q/k/v or gate/up), not the checkpoint. Both give the same
    bits: each value is cast once, from the stored dtype to ``dtype``.
    """
    cfg = PaliGemmaConfig.from_json(os.path.join(model_path, "config.json"))
    model = empty_model(cfg, device, dtype)
    params = dict(model.named_parameters())
    if streaming:
        flat = LazyShardDict(model_path, rename=hf_key_map(LazyShardDict(model_path).keys()))
        for name, keys in _hf_layout(cfg):
            params[name].copy_(_build_param(flat, keys))
        return model, cfg
    sd = hf_to_state_dict(load_safetensors_shards(model_path), cfg)
    if sd.keys() != params.keys():
        raise KeyError(f"checkpoint and model differ in {sorted(sd.keys() ^ params.keys())[:5]}")
    for name, t in sd.items():
        params[name].copy_(t)
    return model, cfg


def load_hf_model(model_path: str, dtype: torch.dtype = torch.bfloat16, device="cuda"):
    """Familiar-name alias for ``load_model`` (reference: utils.py:6):
    returns (model, config); the tokenizer is loaded separately."""
    return load_model(model_path, dtype, device=device)


# ---------------------------------------------------------------------------
# The JAX package's flat parameter file
# ---------------------------------------------------------------------------


def _jax_tree_from_model(model: PaliGemma) -> Dict[str, torch.Tensor]:
    """The flat JAX pytree (``_flatten``'s dotted keys) of a float model: the
    inverse of ``utils/convert.py::state_dict_from_jax``. Layers are stacked
    (L, ...), dense kernels transposed to (in, out), LayerNorm ``weight``
    back to ``scale``; tensors stay on the model's device."""
    _check_float(model, "save_params")
    sd = model.state_dict()
    cfg = model.cfg
    vl, tl = cfg.vision_config.num_hidden_layers, cfg.text_config.num_hidden_layers
    flat: Dict[str, torch.Tensor] = {}

    def stack(fmt, n, t=False):
        return torch.stack([sd[fmt.format(i)].t() if t else sd[fmt.format(i)] for i in range(n)])

    flat["vision.patch_embedding.kernel"] = sd["vision.patch_embedding.weight"].t()
    flat["vision.patch_embedding.bias"] = sd["vision.patch_embedding.bias"]
    flat["vision.position_embedding"] = sd["vision.position_embedding"]
    lay = "vision.layers.{}"
    for jname, pname in (("ln1", "ln1"), ("ln2", "ln2")):
        flat[f"vision.layers.{jname}.scale"] = stack(lay + f".{pname}.weight", vl)
        flat[f"vision.layers.{jname}.bias"] = stack(lay + f".{pname}.bias", vl)
    for jname, pname in (("attn.qkv", "qkv"), ("attn.o", "o"), ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
        flat[f"vision.layers.{jname}.kernel"] = stack(lay + f".{pname}.weight", vl, t=True)
        flat[f"vision.layers.{jname}.bias"] = stack(lay + f".{pname}.bias", vl)
    flat["vision.post_layernorm.scale"] = sd["vision.post_layernorm.weight"]
    flat["vision.post_layernorm.bias"] = sd["vision.post_layernorm.bias"]
    flat["projector.kernel"] = sd["projector.weight"].t()
    flat["projector.bias"] = sd["projector.bias"]
    flat["llm.embed"] = sd["llm.embed"]
    lay = "llm.layers.{}"
    flat["llm.layers.input_ln"] = stack(lay + ".input_ln.weight", tl)
    for name in ("qkv", "o"):
        flat[f"llm.layers.{name}"] = stack(lay + f".{name}.weight", tl, t=True)
    flat["llm.layers.post_ln"] = stack(lay + ".post_ln.weight", tl)
    for name in ("gate_up", "down"):
        flat[f"llm.layers.{name}"] = stack(lay + f".{name}.weight", tl, t=True)
    flat["llm.final_norm"] = sd["llm.final_norm.weight"]
    return flat


def save_params(model: PaliGemma, path: str) -> None:
    """Save a float model as the JAX package's ``save_params`` does: one
    flat safetensors file in its pytree layout, bf16 stored as f32 and
    listed in ``path + ".json"``. Quantized modules raise ``TypeError``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _jax_tree_from_model(model)
    bf16 = sorted(k for k, v in flat.items() if v.dtype == torch.bfloat16)
    out = {k: flat[k].float() if k in bf16 else flat[k] for k in sorted(flat)}
    save_file(out, path)
    with open(path + ".json", "w") as f:
        json.dump({"bfloat16_keys": bf16}, f)


def _unflatten(flat: Mapping[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


@torch.no_grad()
def load_params(path: str, cfg: PaliGemmaConfig, device="cuda",
                dtype: Optional[torch.dtype] = None) -> PaliGemma:
    """A model from a JAX ``save_params`` file (or this module's), through
    ``utils/convert.py``. ``dtype`` None: bf16 when the manifest lists bf16
    keys, else the file's float dtype."""
    flat = load_file(path)
    bf16_keys = set()
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            bf16_keys = set(json.load(f).get("bfloat16_keys", []))
    if dtype is None:
        dtype = torch.bfloat16 if bf16_keys else next(iter(flat.values())).dtype
    tree = _unflatten({k: (v.float() if v.dtype == torch.bfloat16 else v).numpy() for k, v in flat.items()})
    return from_jax_params(tree, cfg, device=device, dtype=dtype)
