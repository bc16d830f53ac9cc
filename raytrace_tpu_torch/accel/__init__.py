"""Acceleration structure: dense triangle clusters for the mesh walk."""
