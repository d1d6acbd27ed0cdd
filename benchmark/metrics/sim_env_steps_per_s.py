"""sim_env_steps_per_s: env-steps of every graphed step the window ran,
over the window's time to the end of its last call, host clock."""


def read(run):
    w = run.window
    if "env_steps" not in w:
        return None
    return w["env_steps"] / (w["end"] - w["start"])
