"""``scene_load_s``: the host clock around ``load_scene`` in the set-up
(the native parser, the OBJ, the BVH build); on several cards the
slowest rank's."""

LAYER = "Scene and BVH (scene/parser.load_scene, scene/bvh.py, native/)"
MOVES = "setup_s"


def read(run, ctx):
    return max(o["scene_load_s"] for o in ctx["outs"])
