"""Host utilities the engine needs (sketches)."""
