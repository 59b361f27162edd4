"""The feature pipeline, the model cascade and the losses."""
