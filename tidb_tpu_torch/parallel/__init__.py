"""The partial/final aggregation split shared by the streamed path (and,
in a later slice, the mesh path)."""
