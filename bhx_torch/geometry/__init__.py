"""Geometry of the port (counterpart of ``bhx/geometry``): analytic ray
intersections (:mod:`.intersect`), the BVH builder (:mod:`.bvh`, numpy and
the C++ core of :mod:`.native`), OBJ loading and :func:`.obj.make_mesh`,
and the mesh traversal (:mod:`.traverse`), whose CUDA kernel is
``bhx_torch/csrc/mesh.cu``."""
