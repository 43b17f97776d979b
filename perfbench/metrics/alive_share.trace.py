"""Useful steps over steps asked for: the agent-steps in which an agent
moved (the points of the returned traces past each seed) over agents x
steps, over the requests of the traced window."""


def read(w):
    if getattr(w, "moved_steps", None) is None or not w.agent_steps:
        return None
    return w.moved_steps / w.agent_steps
