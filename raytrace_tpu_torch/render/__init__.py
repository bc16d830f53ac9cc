"""Renderer driver and render target."""
