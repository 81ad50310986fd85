"""Torch twins of the JAX package's timed demos: the homogeneous Ogden block
(``ogden_block``) and the Ogden/SVK composite (``composite_hyperelasticity``).
Importing them runs nothing."""
