"""The benchmark's plain reference: a frozen copy of the port's plain torch
path for one character (the PMX/VMD/texture loaders in Python, the model
build, animation sampling, tweens, morphs, CCD IK, FK, the rigid-body
solver, skinning, the pair pack, the frame kernel's and the composite's
plain torch twins, the bloom). It imports nothing of the port, so a later
change to the port cannot move it; every kernel is its twin, on whatever
device its tensors are. :mod:`portbench.check` drives it.
"""
