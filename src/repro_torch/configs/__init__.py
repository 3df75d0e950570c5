"""Architecture configs (port of ``repro.configs``): the registry and one
module per decoder-only architecture."""

from repro_torch.configs.base import ARCHS, SHAPES, ShapeSpec, cell_supported, get_config, get_shape, input_specs, reduced

__all__ = ["ARCHS", "SHAPES", "ShapeSpec", "cell_supported", "get_config", "get_shape", "input_specs", "reduced"]
