"""Agent-steps asked for a second: agents x steps of every tracing request
completed in the window over the window's length (host clock). Steps of
agents that already stopped count: they are work the program chooses to
run."""


def read(w):
    return w.agent_steps / w.seconds if w.requests else None
