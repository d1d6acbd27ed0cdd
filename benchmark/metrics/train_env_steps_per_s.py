"""train_env_steps_per_s: env-steps (one step of one lane, all its drones)
of the window's whole PPO epochs over the time from the window's start to
the end of its last epoch, host clock."""


def read(run):
    w = run.window
    if not w.get("epoch_ends"):
        return None
    return len(w["epoch_ends"]) * w["env_steps_per_epoch"] / (w["epoch_ends"][-1] - w["start"])
