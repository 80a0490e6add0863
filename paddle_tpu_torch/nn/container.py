"""paddle_tpu_torch.nn.container — Sequential and LayerList.

Counterpart of ``paddle_tpu/nn/container.py``. Sub-layers are named
``"0"``, ``"1"``, ... as in the JAX package, so state-dict keys match.
"""
from __future__ import annotations

from .layer import Layer


class Sequential(Layer):
    """Accepts layers or ``(name, layer)`` pairs."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                layers[0] and isinstance(layers[0][0], (list, tuple)):
            layers = layers[0]
        for i, item in enumerate(layers):
            name, layer = item if isinstance(item, (list, tuple)) \
                else (str(i), item)
            self.add_module(name, layer)

    def __getitem__(self, idx):
        layers = list(self._modules.values())
        if isinstance(idx, slice):
            return Sequential(*layers[idx])
        return layers[idx]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for layer in sublayers or ():
            self.append(layer)

    def __getitem__(self, idx):
        layers = list(self._modules.values())
        if isinstance(idx, slice):
            return LayerList(layers[idx])
        return layers[idx]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer):
        self.add_module(str(len(self._modules)), layer)
        return self
