"""The benchmark's seeded scenes (:mod:`.spec`) and their file writers
(:mod:`.writers`)."""
