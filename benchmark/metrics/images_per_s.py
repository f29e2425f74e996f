"""images_per_s (host clock): every image of every call the window sent,
over the seconds from the window's start to the end of the last of them
(the window waits for every call it sent)."""


def read(run):
    return run.images / run.seconds if run.seconds > 0 else None
