"""The sharded ILS driver with a fault planted in its decode (the tests'
check that the comparison reads an ordered gather that is out of order):
the whole stream it returns holds rank 1's bytes where rank 0's belong
and rank 0's where rank 1's do."""

from __future__ import annotations

import torch

from benchmark import spec as specs

_sound = specs.driver("ils_sharded")
open_group = _sound.open_group
close_group = _sound.close_group
input_shape = _sound.input_shape
fit = _sound.fit
encode = _sound.encode
container = _sound.container


def decode(codec, shard):
    out = _sound.decode(codec, shard)
    n = out.numel() // codec.mesh.size
    return torch.cat([out[n:2 * n], out[:n], out[2 * n:]])
