"""Registry of FL-plane models (paper Table II) by name.

Each entry: name -> (init_fn(gen, num_classes, image), apply_fn(params, x)),
where ``gen`` is a ``torch.Generator`` and the parameters come back on the
CPU; the caller moves them to its device.
"""
from __future__ import annotations

from repro_torch.models.cnn import (
    apply_cnn,
    apply_resnet10,
    apply_resnet18,
    init_cnn1,
    init_cnn2,
    init_resnet10,
    init_resnet18,
)

FL_MODELS = {
    "cnn1": (lambda gen, num_classes=10, image=16: init_cnn1(gen, num_classes, image=image), apply_cnn),
    "cnn2": (lambda gen, num_classes=10, image=16: init_cnn2(gen, num_classes, image=image), apply_cnn),
    "resnet10": (lambda gen, num_classes=10, image=16: init_resnet10(gen, num_classes), apply_resnet10),
    "resnet18": (lambda gen, num_classes=10, image=16: init_resnet18(gen, num_classes), apply_resnet18),
}


def get_fl_model(name: str):
    if name not in FL_MODELS:
        raise KeyError(f"unknown FL model {name!r}; known: {sorted(FL_MODELS)}")
    return FL_MODELS[name]
