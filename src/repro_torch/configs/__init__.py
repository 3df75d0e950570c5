"""Architecture configs (port of ``repro.configs``): the registry and the
architectures whose blocks the port has."""

from repro_torch.configs.base import ARCHS, SHAPES, ShapeSpec, cell_supported, get_config, get_shape, reduced

__all__ = ["ARCHS", "SHAPES", "ShapeSpec", "cell_supported", "get_config", "get_shape", "reduced"]
