"""Host-side shape code (numpy): PLY meshes, Loop subdivision, curves,
NURBS and the hyperboloid, each tessellated to triangles at parse time
(port of pbrt_tpu.shapes)."""
