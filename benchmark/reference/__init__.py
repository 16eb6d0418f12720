"""The plain reference that decides ``correct``: a frozen copy of the
counter RNG and of the megakernel's plain tracer (spheres, cubes, BVH
meshes, next-event estimation), in plain PyTorch, differentiable in the
geoms' translations.  It imports nothing of the program and works out
again every table the program derives (camera basis, transforms, light
tables, triangle rows, the BVH) from the configuration's own numbers."""
