"""Model architectures by name: each configuration file names its own.

A configuration's ``"arch"`` names a module ``benchmark/archs/<arch>.py``,
the one place that knows the model's layout. The harness reaches the layout
only through its hooks, each of which takes the configuration dict:

- ``groups(config)``: the weight groups in a fixed order, each a list of
  ``(name, shape, std, mean)`` (``harness/weights.py`` makes them);
- ``build_model(config, W) -> (model, processor)``: the port's model over
  the tensors of ``W``, in the configuration's serving format;
- ``reference(W, config, fmt)``: the plain reference with
  ``served_logits(items)``, its decoder's weights in format ``fmt``;
- ``inputs(config, image, prompt) -> (pixels, token_ids)``: what the
  reference reads of a request;
- ``n_image_tokens(config)``: the prompt positions an image takes;
- ``request_flops(config, positions, first, last)``: the operations that
  tokens ``first`` .. ``last - 1`` of a request need (``step.mfu``).

A new architecture is a new module here, with its reference, its kernels'
counts and metric readers in files of their own.
"""
from __future__ import annotations

import importlib
import importlib.util
import re
from types import ModuleType

NAME = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def load(config: dict) -> ModuleType:
    """The module that ``config["arch"]`` names; no default."""
    source = f"benchmark/configs/{config.get('name')}.json"
    arch = config.get("arch")
    if not arch:
        raise ValueError(f"{source} names no architecture: give it \"arch\", a module of benchmark/archs/")
    if not isinstance(arch, str) or not NAME.fullmatch(arch) or importlib.util.find_spec(f"{__name__}.{arch}") is None:
        raise ValueError(f"{source} names the architecture {arch!r}, and there is no benchmark/archs/{arch}.py")
    return importlib.import_module(f"{__name__}.{arch}")
