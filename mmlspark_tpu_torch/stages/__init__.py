"""Pipeline stages: the image stages."""
