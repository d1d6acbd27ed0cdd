"""setup_s: process start to the first timed unit (building, loading,
warming up, capturing), host clock."""


def read(run):
    return run.setup_s
