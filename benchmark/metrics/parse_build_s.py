"""Seconds the program's parser and scene build took in set-up (host
clock around `parser.api.parse_scene`, which builds the scene)."""


def read(trace):
    return trace["setup"].get("parse_build_s")
