"""Scene constants shared by the render path."""
