"""Host milliseconds a frame: from the client asking for the frame until
its calls into the renderer return (the camera move and the passes), not
counting the wait for the copy to the host; the mean over the window."""


def read(run):
    frames = run.state.get("frames")
    if not frames:
        return None
    return sum(td - ts for ts, td, _ in frames) / len(frames) * 1e3
