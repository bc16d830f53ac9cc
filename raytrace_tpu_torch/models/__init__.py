"""Scene model: scheme schema, camera, numpy scene arrays."""
