"""Host-device synchronizations a frame window makes, counted under
torch's sync debug mode."""


def read(rec):
    if rec.syncs is None or not rec.sync_windows:
        return None
    return rec.syncs / rec.sync_windows
