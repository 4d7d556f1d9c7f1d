"""Input pileup sites of all requests completed in the window over the
window's wall, from the first request's start to the last one's end."""


def read(run):
    return run.requests * run.sites_per_request / run.window_s
